"""The training loss and its gradient of the families with recurrent
state, zamba2-2.7b (hybrid) and xlstm-350m (ssm), against the reference's
``jax.value_and_grad(model.loss)``: the check and tolerances of
``tests/test_torch_loss.py``, in a file of their own to keep each file's
run short."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_loss import DTYPES, check_loss_and_gradients, one_thread  # noqa: E402, F401


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-350m"])
def test_loss_and_gradients_match_reference(arch, dtype):
    check_loss_and_gradients(arch, dtype)
