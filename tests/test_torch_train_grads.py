"""Port parity, training in f32: ``loss_fn`` and its gradients for every
reduced arch against the reference's jitted ``jax.value_and_grad``, on the
reference's params (``PRNGKey(0)``, through ``params_from_numpy``) and
numpy tokens.

Bars: the loss within 1e-5 relative; each gradient leaf (the port's
per-layer leaves restacked) within 1e-4 of the reference leaf's largest
|value| (measured: 1.5e-6 for the attention archs, 6e-5 for the SSM
ones).  A leaf that is zero in exact arithmetic -- llama4's router under
top-1 routing, whose normalized weight is 1 whatever the logits -- reads
rounding noise in both packages (7e-9 here, against 6.6e-2 for the
largest leaf) and is held to zero within 1e-6 of the model's largest
gradient.  The params are left without ``requires_grad``.
"""
import pytest

from repro_torch.configs import ARCHS
from repro_torch.train import step as tstep
from repro_torch.tree import leaves

from _torch_support import as_torch, grads_close, jax_value_and_grad, model_batch, model_pair
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)

B, T = 2, 32


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_reference(arch):
    cfg, jp, p = model_pair(arch)
    batch = model_batch(cfg, B, T, seed=1)
    want_loss, want = jax_value_and_grad(cfg, jp, batch)
    loss, grads = tstep.value_and_grad(p, cfg, as_torch(batch, cfg))
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    grads_close(cfg, grads, want, 1e-4)
    assert not any(t.requires_grad for t in leaves(p))
