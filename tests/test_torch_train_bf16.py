"""Port parity, training in bf16: ``loss_fn`` and its gradients for every
reduced arch with bf16 weights (the reference's own dtypes: the SSM's
A_log/D/dt_bias and the MoE router stay f32), against the reference's
``jax.value_and_grad`` on the same weights and tokens.

Bars, from what the two stacks read (each bf16 rounding may differ by
2^-8 relative): the loss within 1e-3 relative for every arch (measured at
most 2.8e-4); the gradients within 5e-2 of each leaf's largest |value|
for the dense, SWA, VLM and enc-dec archs (measured at most 3.4e-2).  The
SSM, hybrid and MoE families' bf16 gradients drift further (mamba2 0.09,
qwen3-moe 0.14, zamba2 0.31 of a leaf's max: depth, and routing after a
rounding), as their bf16 forwards do in ``tests/_torch_support.py``; their
gradients are held in f32 (``tests/test_torch_train.py``).
"""
import pytest

from repro_torch.configs import ARCHS
from repro_torch.train import step as tstep

from _torch_support import as_torch, grads_close, jax_value_and_grad, model_batch, model_pair
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)

B, T = 2, 32


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_bf16(arch):
    cfg, jp, p = model_pair(arch, dtype="bfloat16")
    batch = model_batch(cfg, B, T, seed=1)
    want_loss, want = jax_value_and_grad(cfg, jp, batch)
    loss, grads = tstep.value_and_grad(p, cfg, as_torch(batch, cfg))
    assert abs(float(loss) - want_loss) <= 1e-3 * abs(want_loss)
    if cfg.family in ("dense", "vlm") or cfg.is_encdec:
        grads_close(cfg, grads, want, 5e-2)
