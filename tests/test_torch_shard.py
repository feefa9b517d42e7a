"""Port parity, sharding: repro_torch.shard against repro.shard, the MoE's
group-local dispatch, ``cs``, and the sharded model plane on real ranks.

1. The rules, leaf for leaf: ``params_pspecs`` of every arch at full width
   (the port's ``abstract_params`` on ``meta`` against the reference's
   ``abstract_params``, ``fsdp_pods`` both ways), ``batch_pspecs_for_mesh``,
   ``cache_pspecs`` (kv heads dividing the model axis and not),
   ``fix_divisibility``, ``validate_pspecs`` and ``make_ctx`` over
   duck-typed meshes that both packages read.  Specs compare as tuples; a
   layer's leaf of the port (a list of per-layer dicts) has the
   reference's stacked spec without its leading None.
2. The MoE dispatch of ``tests/test_moe_dispatch.py``: G = 4 groups
   against the reference's G = 4 and against the port's own G = 1.
3. ``cs``: a no-op when disabled, a raise for a plain tensor under a mesh.
4. Real collectives: 4 gloo ranks on this CPU (``_torch_shard_ranks.py``,
   spawned once), on a (data=2, model=2) and a (data=1, model=4) mesh --
   the second the GQA case, 2 kv heads on 4 model ranks.  Every reduced
   family's sharded forward within 1e-5 of max |logit| of the unsharded
   port (dense and SSM: prefill, decode and the cache too), the MoE at
   4096 tokens (one group per data rank), one dense train step with two
   microbatches (loss 1e-6 relative, read on each rank; params by tree
   distance within 1e-3 of the distance moved), ``Engine(ctx=)``'s greedy
   tokens equal to the unsharded engine's and ``Trainer(ctx=)``'s first
   loss within 1e-5.  The ``cuda`` test runs tinyllama-1.1b at full width
   in bf16 through the kernels on four cards.
"""
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import api
from repro_torch.shard import (
    NO_SHARD, P, ShardCtx, batch_pspecs_for_mesh, cache_pspecs, cs, fix_divisibility,
    make_ctx, params_pspecs, validate_pspecs)

from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

#: duck-typed meshes both packages read: the port through
#: ``mesh_dim_names``/``shape``, the reference through ``axis_names``/``devices``
MESH_SHAPES = {(1,): ("model",), (4,): ("model",), (2, 4): ("data", "model"),
               (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


class FakeMesh:
    def __init__(self, shape, names):
        self.shape = self.devices_shape = tuple(shape)
        self.mesh_dim_names = self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


def _mesh(shape):
    return FakeMesh(shape, MESH_SHAPES[shape])


def _ref_specs(tree):
    """{path without list indices: spec tuple} of the reference's spec tree."""
    import jax
    from jax.sharding import PartitionSpec

    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {tuple(getattr(k, "key", None) for k in path): tuple(s) for path, s in flat}


def _port_specs(tree, path=()):
    """[(dict-key path, spec tuple, stacked)] of the port's spec tree."""
    if isinstance(tree, P):
        return [(path, tuple(tree), False)]
    if isinstance(tree, dict):
        return [x for k in tree for x in _port_specs(tree[k], path + (k,))]
    return [(p, s, True) for v in tree for p, s, _ in _port_specs(v, path)]


def _same_specs(port, ref):
    """Every port leaf's spec equals the reference's (without the stacked
    axis' leading None for a layer's leaf), and every reference leaf has
    one."""
    ref = _ref_specs(ref)
    seen = set()
    for path, spec, stacked in _port_specs(port):
        want = ref[path]
        if stacked:
            assert want[0] is None, path
            want = want[1:]
        assert spec == want, (path, spec, want)
        seen.add(path)
    assert seen == set(ref)


@pytest.fixture(scope="module")
def abstract():
    """{arch: (the port's params on meta, the reference's ShapeDtypeStructs)}."""
    from repro.models import api as japi

    return {name: (api.abstract_params(cfg), japi.abstract_params(cfg))
            for name, cfg in ARCHS.items()}


# ---------------------------------------------------------------------------
# 1. the rules against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fsdp_pods", [False, True])
def test_params_pspecs_match_reference(abstract, fsdp_pods):
    from repro.shard import params_pspecs as ref_pspecs

    for name, (tp, jp) in abstract.items():
        _same_specs(params_pspecs(tp, fsdp_pods=fsdp_pods), ref_pspecs(jp, fsdp_pods=fsdp_pods))


def test_shard_rules_cover_all_archs(abstract):
    """Every param leaf of every arch gets a rank-matching spec (the case of
    ``tests/test_dryrun.py``)."""
    from repro_torch.tree import leaves

    for name, (tp, _) in abstract.items():
        arrs, specs = leaves(tp), _spec_leaf_order(params_pspecs(tp))
        assert len(arrs) == len(specs)
        for a, s in zip(arrs, specs):
            assert len(s) == a.dim(), (name, a.shape, s)


def _spec_leaf_order(tree):
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaf_order(tree[k])]
    return [s for v in tree for s in _spec_leaf_order(v)]


@pytest.mark.parametrize("shape", [(2, 4), (16, 16), (2, 16, 16)])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "h2o-danube-3-4b", "qwen3-moe-235b-a22b",
                                  "seamless-m4t-medium", "mamba2-370m", "zamba2-2.7b"])
def test_fix_divisibility_and_validate_match_reference(abstract, arch, shape):
    from repro.shard import fix_divisibility as ref_fix
    from repro.shard import params_pspecs as ref_pspecs
    from repro.shard import validate_pspecs as ref_validate

    tp, jp = abstract[arch]
    pods = len(shape) == 3
    mesh = _mesh(shape)
    specs, jspecs = params_pspecs(tp, fsdp_pods=pods), ref_pspecs(jp, fsdp_pods=pods)
    _same_specs(fix_divisibility(tp, specs, mesh), ref_fix(jp, jspecs, mesh))

    def problems(msgs, stacked_shift):
        out = set()
        for m in msgs:
            path, dim, ext, n = re.match(r"(.*): dim (\d+) \((\d+)\) % mesh.*=(\d+) != 0", m).groups()
            ints = re.findall(r"\[\d+\]", path)
            out.add((re.sub(r"\[\d+\]", "", path).replace('"', "'"),
                     int(dim) + (stacked_shift if ints else 0), int(ext), int(n)))
        return out

    # the reference names a stacked leaf once, its dims one further on
    assert problems(validate_pspecs(tp, specs, mesh), 1) == \
        problems(ref_validate(jp, jspecs, mesh), 0)


def test_fix_divisibility_drops_bad_axes():
    """The case of ``tests/test_dryrun.py``: a 4-wide model axis is dropped
    from a 7-long dim and kept on an 8-long one."""
    one = FakeMesh((1,), ("model",))
    t = {"a": torch.empty((7, 8), device="meta")}
    assert fix_divisibility(t, {"a": P("model", None)}, one)["a"] == P("model", None)
    four = FakeMesh((4,), ("model",))
    assert fix_divisibility(t, {"a": P("model", None)}, four)["a"] == P(None, None)
    t = {"a": torch.empty((8, 7), device="meta")}
    assert fix_divisibility(t, {"a": P("model", None)}, four)["a"] == P("model", None)


def _batches():
    d = 64
    out = []
    for B in (1, 2, 16, 32, 256):
        out.append({"tokens": (B, 128), "src_embeds": (B, 128, d), "token": (B,)})
    return out


@pytest.mark.parametrize("shape", list(MESH_SHAPES))
def test_batch_pspecs_and_make_ctx_match_reference(shape):
    import jax
    import jax.numpy as jnp
    from repro.shard import batch_pspecs_for_mesh as ref_batch
    from repro.shard import make_ctx as ref_ctx

    mesh = _mesh(shape)
    for b in _batches():
        tb = {k: torch.empty(s, device="meta") for k, s in b.items()}
        jb = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in b.items()}
        _same_specs(batch_pspecs_for_mesh(tb, mesh), ref_batch(jb, mesh))
    got, want = make_ctx(mesh), ref_ctx(mesh)
    for f in ("batch_axes", "model_axis", "enabled", "batch_size_product", "model_size"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("shape", list(MESH_SHAPES))
@pytest.mark.parametrize("arch,kv_heads", [
    ("tinyllama-1.1b", 4),         # 4 kv heads: divide 1, 2, 4; not 16 -> hd
    ("deepseek-67b", 8),
    ("seamless-m4t-medium", 16),   # cross K/V too
    ("mamba2-370m", None),         # ssm state and conv
    ("zamba2-2.7b", 32)])          # both
def test_cache_pspecs_match_reference(shape, arch, kv_heads):
    import jax
    from repro.models import api as japi
    from repro.shard import cache_pspecs as ref_cache

    cfg = get_config(arch)
    mesh = _mesh(shape)
    for B in (1, 16):
        src = 64 if cfg.is_encdec else None
        tc = api.init_cache(cfg, B, 64, src_len=src, device="meta")
        jc = jax.eval_shape(lambda: japi.init_cache(cfg, B, 64, src_len=src))
        for kv in (kv_heads, None):
            _same_specs(cache_pspecs(tc, mesh, kv_heads=kv), ref_cache(jc, mesh, kv_heads=kv))


# ---------------------------------------------------------------------------
# 2. the MoE's group-local dispatch
# ---------------------------------------------------------------------------


def test_moe_group_dispatch_matches_reference():
    """``tests/test_moe_dispatch.py``'s invariance through both packages:
    G = 4 groups (a context with batch degree 4 and no mesh) equals the
    reference's G = 4 and the port's own G = 1 when no token is dropped."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import moe_block as ref_moe
    from repro.models.layers import moe_init
    from repro.shard.spec import ShardCtx as RefCtx
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import layers as L
    from repro_torch.models.params import _map, _tensor

    cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=64, n_heads=2,
                      n_kv_heads=2, d_ff=32, vocab=64, n_experts=4, top_k=2,
                      capacity_factor=8.0, n_shared_experts=0, dtype="float32")
    jp = moe_init(jax.random.key(0), cfg, jnp.float32)
    p = _map(jp, lambda a, _: _tensor(np.asarray(a), "cpu"))
    x = np.random.default_rng(1).normal(size=(4, 2048, cfg.d_model)).astype(np.float32)
    ctx4 = ShardCtx(batch_axes=None, model_axis=None, enabled=True,
                    batch_size_product=4, model_size=1)
    assert L.moe_groups(ctx4, 4 * 2048) == 4 and L.moe_groups(NO_SHARD, 4 * 2048) == 1
    ref4 = np.asarray(ref_moe(jp, jnp.asarray(x), cfg, ctx=RefCtx(
        batch_axes=None, model_axis=None, enabled=True, batch_size_product=4, model_size=1)))
    y4 = L.moe_block(p, torch.from_numpy(x), cfg, ctx=ctx4).numpy()
    y1 = L.moe_block(p, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(y4, ref4, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(y4, y1, atol=2e-4, rtol=2e-4)


def test_moe_groups_change_the_drops_as_the_reference():
    """Where tokens are dropped, G changes which: the port's G = 4 output
    follows the reference's G = 4, not its own G = 1."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import moe_block as ref_moe
    from repro.models.layers import moe_init
    from repro.shard.spec import ShardCtx as RefCtx
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import layers as L
    from repro_torch.models.params import _map, _tensor

    cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=32, n_heads=2,
                      n_kv_heads=2, d_ff=16, vocab=64, n_experts=4, top_k=2,
                      capacity_factor=1.0, n_shared_experts=0, dtype="float32")
    jp = moe_init(jax.random.key(2), cfg, jnp.float32)
    p = _map(jp, lambda a, _: _tensor(np.asarray(a), "cpu"))
    x = np.random.default_rng(3).normal(size=(4, 1024, cfg.d_model)).astype(np.float32)
    ref4 = np.asarray(ref_moe(jp, jnp.asarray(x), cfg, ctx=RefCtx(batch_size_product=4)))
    y4 = L.moe_block(p, torch.from_numpy(x), cfg, ctx=ShardCtx(batch_size_product=4)).numpy()
    y1 = L.moe_block(p, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(y4, ref4, atol=2e-4 * np.abs(ref4).max(), rtol=0)
    assert np.abs(y1 - y4).max() > 1e-2 * np.abs(ref4).max()


# ---------------------------------------------------------------------------
# 3. cs
# ---------------------------------------------------------------------------


def test_cs_is_a_noop_when_disabled_or_replicated():
    x = torch.randn(4, 8)
    assert cs(x, "batch", None, ctx=NO_SHARD) is x
    ctx = ShardCtx(batch_axes=None, model_axis=None, batch_size_product=4)
    assert cs(x, "batch", "model", ctx=ctx) is x  # every entry resolves to None


def test_cs_raises_for_a_plain_tensor_under_a_mesh():
    ctx = make_ctx(FakeMesh((2, 2), ("data", "model")))
    with pytest.raises(TypeError, match="DTensor"):
        cs(torch.randn(4, 8), "batch", None, ctx=ctx)
    with pytest.raises(ValueError, match="no mesh"):
        cs(torch.randn(4, 8), "batch", None, ctx=ShardCtx(batch_axes=("data",)))


# ---------------------------------------------------------------------------
# 4. real collectives: 4 ranks
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(tmp, world=4, extra=(), timeout=240):
    """Run ``_torch_shard_ranks.py`` as ``world`` processes; returns rank
    0's results (each rank killed at ``timeout`` s)."""
    out = str(tmp / "shard_results.json")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_shard_ranks.py"), str(r), str(world),
         str(port), out, *extra], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, cwd=REPO) for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a rank timed out:\n" + "\n".join(logs)[-3000:])
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    return spawn_ranks(tmp_path_factory.mktemp("shard"))


CASES = [f"{m}/{c}" for m in ("data2_model2", "data1_model4")
         for c in (*sorted(ARCHS), "moe-groups", "train", "engine-trainer")]


@pytest.mark.parametrize("case", CASES)
def test_sharded_model_equals_unsharded(gloo_results, case):
    r = gloo_results[case]
    assert r["ok"], r.get("error") or (r["err"], r["bar"])


@pytest.mark.cuda
def test_sharded_tinyllama_on_four_cards(tmp_path):
    """tinyllama-1.1b at full width, bf16, through the kernels, on four
    NCCL ranks (data=2, model=2): forward, prefill and one decode step
    against each rank's unsharded model, within 3e-2 of max |logit|."""
    from _torch_support import require_card

    require_card()
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 cards, found {torch.cuda.device_count()}")
    res = spawn_ranks(tmp_path, extra=("nccl", "cuda"), timeout=600)
    r = res["data2_model2/tinyllama-1.1b-full-bf16-pallas"]
    print(json.dumps(res))
    assert r["ok"], r.get("error") or r["err"]
