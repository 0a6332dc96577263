"""Core: N:M sparsity with structured outliers and variance correction."""

from .ebft import (EBFTConfig, ebft_block, masked_adam_init,
                   masked_adam_step)
from .equalize import (check_equivalence, equalize_weights,
                       equalized_view_for_scoring, smoothquant_scales)
from .outliers import (OUTLIER_M, StructuredOutliers,
                       extract_structured_outliers, pack_outlier_meta,
                       structured_outlier_mask, unpack_outlier_meta,
                       unstructured_outlier_mask)
from .packing import (PackedNM, compression_report, dense_bytes, pack_nm,
                      unpack_metadata)
from .patterns import (OUTLIER_PATTERNS, WEIGHT_PATTERNS, Pattern,
                       block_topn_indices, mask_sparsity, nm_mask,
                       parse_pattern, topn_block_mask, validate_nm_mask)
from .pipeline import (SparsifiedLinear, SparsifyConfig,
                       dense_effective_weight, default_prunable,
                       sparsify_linear, sparsify_tree)
from .scoring import ActStats, ria_score, score, wanda_score
from .variance import apply_variance_correction, variance_correction_factor
