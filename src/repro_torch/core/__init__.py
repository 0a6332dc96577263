"""Core: N:M sparsity with structured outliers and variance correction."""

from .outliers import (OUTLIER_M, StructuredOutliers,
                       extract_structured_outliers, pack_outlier_meta,
                       unpack_outlier_meta)
from .packing import PackedNM, pack_nm, unpack_metadata
from .patterns import (Pattern, block_topn_indices, nm_mask, parse_pattern,
                       topn_block_mask)
from .pipeline import SparsifiedLinear, SparsifyConfig, sparsify_linear
from .variance import apply_variance_correction, variance_correction_factor
