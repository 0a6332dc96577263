"""``test_torch_mesh_serving.py``'s tests on a gloo mesh of 1x8 ranks: the
reference's 8 KV heads split one a rank, the GQA twin's 2 divide neither
mesh (arenas replicated), and the fleet runs 2 replicas of 1x4.  A file
of its own so ``--dist loadfile`` runs it beside the 1x4 world."""
import pytest

pytest.importorskip("torch")

from test_torch_mesh_serving import (  # noqa: E402,F401
    _one_torch_thread, jax_fleet, jax_runs, jax_spec_runs, mesh_run, models,
    test_mesh_arenas_weights_and_plans, test_mesh_engine_token_identical_to_jax,
    test_mesh_pool_stats_and_placement,
    test_mesh_sampled_streams_equal_single_device,
    test_mesh_speculation_token_identical_to_jax,
    test_replica_mesh_fleet_decisions_equal_jax,
    test_serve_cli_fleet_on_replica_meshes, test_serve_cli_on_the_mesh)


@pytest.fixture(scope="module")
def world():
    """Eight ranks on the model axis."""
    return 8
