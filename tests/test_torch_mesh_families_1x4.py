"""``test_torch_mesh_families.py``'s tests on a gloo mesh of 1x4 ranks:
xlstm's state splits its value columns (the sLSTM carries whole),
zamba2's twin its P columns, mixtral's 2 KV heads do not divide 4 ranks
(arenas whole), whisper's 4 do.  A file of its own so ``--dist loadfile``
runs it beside the 1x2 world."""
import pytest

pytest.importorskip("torch")

from test_torch_mesh_families import (  # noqa: E402,F401
    _one_torch_thread, jax_runs, mesh_run, mesh_spawn, models, solo_states,
    test_mesh_arenas_and_context_rows_hold_rank_heads,
    test_mesh_experts_split_on_last_dim, test_mesh_family_ranks_in_lockstep,
    test_mesh_family_streams_equal_jax,
    test_mesh_state_leaves_are_blocks_by_reference_spec)


@pytest.fixture(scope="module")
def world():
    """Four ranks on the model axis."""
    return 4
