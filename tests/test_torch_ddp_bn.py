"""The 2-rank data-parallel train step of the port with batch-statistics
BN, against JAX's step on the global batch (``tests/test_torch_ddp.py::
check_two_rank_step``): the ranks' BNs normalize over the global batch
through one all-reduce of their statistics.  In a file of its own so that
each file's JAX compile stays within its time."""
from tests.test_torch_ddp import _one_torch_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_ddp import check_two_rank_step


def test_two_rank_step_matches_jax_global_batch_under_batch_statistics():
    check_two_rank_step(train_bn=True)
