"""Multi-pod dry run: run every (arch x shape x mesh) cell once on fake ranks.

Port of ``repro.launch.dryrun``.  Where the reference lowers and compiles
each cell for 512 host-platform devices, the port joins a *fake* process
group of the mesh's size (``torch.testing._internal.distributed.fake_pg``:
every collective returns at once, rank 0 holds its shards) and runs the
cell's step once under ``FakeTensorMode`` -- no tensor has storage, no
card is touched -- with the params, optimizer state and cache as fake
``DTensor``s placed by the rules.  For each cell it records (under
``--out``):

  * memory per device: ``argument_bytes`` (rank 0's shards of the
    params, optimizer state, batch and cache), ``output_bytes`` (the
    step's outputs that are new storage), ``alias_bytes`` (outputs
    written into the arguments: the train step's params and state),
    ``temp_bytes`` (the most the step's other allocations held at once)
    and ``peak_bytes`` = argument + output + temp - alias, the
    reference's sum;
  * ``cost.flops`` (matrix-product flops per device, trip-count-aware)
    and ``cost.bytes_accessed`` (per-operation traffic), from
    ``op_analysis``;
  * the collective inventory with the reference's ring model.

Left out, having no meaning here: ``xla_flops_raw``/``xla_bytes_raw``,
``lower_s``/``compile_s`` and the HLO dump.  The printed line compares
the per-device peak with an H100's 80 GB.

The fake group is global to a process, so a dry run is a process of its
own (the tests run it by subprocess).  Its mesh is CPU-typed: the
collectives that ran are counted (the model plane issues all-gathers,
reduce-scatters and all-reduces; its MoE issues no all-to-all).

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --arch mamba2-370m --shape decode_32k \\
      --devices 8 --batch 16 --out /tmp/dr   # scaled-down mesh for CI
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_config
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh, scaled_mesh_dims
from repro_torch.launch.op_analysis import analyze_ops
from repro_torch.models import api
from repro_torch.models.layers import dtype_of
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.shard import cache_pspecs, distribute, make_ctx, params_pspecs
from repro_torch.shard.spec import local, mesh_sizes
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves, unflatten

#: an H100's memory, the bar the printed line compares the peak with
CARD_BYTES = 80e9


# ---------------------------------------------------------------------------
# input specs (meta stand-ins; no allocation)
# ---------------------------------------------------------------------------


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape_name: str, *, batch_override=None):
    """Batch dict of meta tensors for one cell (src len == seq for
    train/prefill; 4096 for decode, as the reference's)."""
    sh = SHAPES[shape_name]
    B = batch_override or sh["global_batch"]
    T = sh["seq_len"]
    dt = dtype_of(cfg.dtype)
    if sh["kind"] in ("train", "prefill"):
        if cfg.is_encdec:
            return {"tokens": _meta((B, T), torch.int32),
                    "src_embeds": _meta((B, T, cfg.d_model), dt)}
        if cfg.frontend == "vision":
            return {"tokens": _meta((B, T - cfg.n_prefix_tokens), torch.int32),
                    "prefix_embeds": _meta((B, cfg.n_prefix_tokens, cfg.d_model), dt)}
        return {"tokens": _meta((B, T), torch.int32)}
    if sh["kind"] == "decode":
        return {"token": _meta((B,), torch.int32)}
    raise ValueError(shape_name)


def cache_specs(cfg, shape_name: str, *, batch_override=None):
    sh = SHAPES[shape_name]
    B = batch_override or sh["global_batch"]
    T = sh["seq_len"]
    src = 4096 if cfg.is_encdec and sh["kind"] == "decode" else T
    return api.init_cache(cfg, B, T, src_len=src if cfg.is_encdec else None, device="meta")


def default_microbatches(cfg, shape_name, mesh, batch_override=None) -> int:
    """Enough grad-accumulation that one microbatch is ~1 seq per data shard."""
    if SHAPES[shape_name]["kind"] != "train":
        return 1
    sizes = mesh_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    B = batch_override or SHAPES[shape_name]["global_batch"]
    per_shard = max(B // dp, 1)
    if cfg.d_model >= 4096 or cfg.n_layers >= 48:
        return per_shard  # 1 seq per shard per microbatch
    return max(per_shard // 4, 1)


def default_remat(cfg):
    """Per-family activation policy, the reference's: grouped recursive
    checkpointing for deep dense stacks, plain full remat otherwise."""
    if cfg.family in ("dense", "vlm") and cfg.n_layers >= 40:
        return "group:8"
    return "full"


# ---------------------------------------------------------------------------
# fake tensors
# ---------------------------------------------------------------------------


def _fake(tree, device):
    """Fake tensors with ``tree``'s (meta) shapes and dtypes.  Call under
    ``FakeTensorMode``."""
    return unflatten(tree, [torch.empty(t.shape, dtype=t.dtype, device=device)
                            for t in leaves(tree)])


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def build_cell(cfg, shape_name, mesh, *, microbatches=None, remat=None,
               batch_override=None, lean=True):
    """Returns (fn, args, extra): ``fn(*args)`` is the cell's step on fake
    ``DTensor``s.  Call under ``FakeTensorMode``."""
    remat = remat or default_remat(cfg)
    ctx = make_ctx(mesh)
    sh = SHAPES[shape_name]
    params_meta = api.abstract_params(cfg)
    params = distribute(_fake(params_meta, mesh.device_type), params_pspecs(params_meta), mesh)
    # the batch: the same global tensors on every rank
    batch = _fake(input_specs(cfg, shape_name, batch_override=batch_override),
                  mesh.device_type)

    if sh["kind"] == "train":
        mb = microbatches or default_microbatches(cfg, shape_name, mesh, batch_override)
        ocfg = AdamWConfig(state_dtype="bfloat16" if lean else "float32")
        opt = adamw.init_for(ocfg, params)
        step = make_train_step(cfg, ocfg, ctx=ctx, microbatches=mb, remat=remat,
                               acc_dtype=torch.bfloat16 if lean else torch.float32)
        return step, (params, opt, batch), {"microbatches": mb}

    cache_meta = cache_specs(cfg, shape_name, batch_override=batch_override)
    cache = distribute(_fake(cache_meta, mesh.device_type),
                       cache_pspecs(cache_meta, mesh, kv_heads=cfg.n_kv_heads or None), mesh)
    if sh["kind"] == "prefill":
        def fn(params, batch, cache):
            return api.prefill(params, cfg, batch, cache, ctx=ctx)

        return fn, (params, batch, cache), {}

    def fn(params, batch, cache):
        return api.decode_step(params, cfg, batch["token"], cache, ctx=ctx)

    return fn, (params, batch, cache), {}


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def _local_bytes(tensors) -> int:
    seen, n = set(), 0
    for t in tensors:
        st = local(t).untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += st.nbytes()
    return n


def _join_fake_world(n: int):
    """This process as rank 0 of a fake group of ``n`` ranks (or of the
    larger one already up)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() < n:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is up; "
                               f"the dry run needs {n}")
        return
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())


def _mesh(devices, multi, shape, names, n_chips):
    """The cell's CPU-typed mesh: ``launch.mesh``'s where the world is its
    size, else over the world's first ``n_chips`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if dist.get_world_size() == n_chips:
        return (make_test_mesh(int(devices), multi_pod=multi, device_type="cpu") if devices
                else make_production_mesh(multi_pod=multi, device_type="cpu"))
    return DeviceMesh("cpu", torch.arange(n_chips).reshape(shape), mesh_dim_names=names)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, devices=None,
             microbatches=None, remat=None, out_dir="experiments/dryrun_torch",
             batch_override=None, tag="", baseline=False, lean=True):
    from torch._subclasses.fake_tensor import FakeTensorMode

    if baseline:
        # paper-faithful first implementation: dense attention, sequential
        # SSD scan, f32 optimizer states, plain full remat
        import repro_torch.models.layers as _L
        import repro_torch.models.ssm as _S

        _L.CHUNKED_ATTN_THRESHOLD = 1 << 60
        _S.SSD_MODE = "sequential"
        lean = False
        remat = remat or "full"

    suffix = f"_{tag}" if tag else ""
    path = os.path.join(out_dir, f"{arch}_{shape_name}_{mesh_kind}{suffix}.json")
    cfg = get_config(arch)
    if shape_name not in applicable_shapes(cfg):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "skipped",
               "reason": "quadratic attention at 500k (see DESIGN.md)",
               "tag": tag}
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec
    multi = mesh_kind == "multipod"
    if devices:
        shape, names = scaled_mesh_dims(int(devices), multi_pod=multi)
    else:
        shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi \
            else ((16, 16), ("data", "model"))
    n_chips = 1
    for s in shape:
        n_chips *= s
    _join_fake_world(n_chips)
    mesh = _mesh(devices, multi, shape, names, n_chips)

    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mesh_shape": dict(zip(names, shape)),
           "remat": remat or default_remat(cfg),
           "lean": lean, "tag": tag, "baseline": baseline}
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            fn, args, extra = build_cell(
                cfg, shape_name, mesh, microbatches=microbatches, remat=remat,
                batch_override=batch_override, lean=lean)
            rec.update(extra)
            arg_leaves = leaves(args)
            arg_bytes = _local_bytes(arg_leaves)
            result, ops = analyze_ops(fn, *args, external=[local(t) for t in arg_leaves])
            arg_st = {id(local(t).untyped_storage()) for t in arg_leaves}
            out_leaves = [local(t) for t in leaves(result) if isinstance(t, torch.Tensor)]
            alias = _local_bytes([t for t in out_leaves if id(t.untyped_storage()) in arg_st])
            out_new = _local_bytes([t for t in out_leaves
                                    if id(t.untyped_storage()) not in arg_st])
        temp = max(ops["peak_live_bytes"] - out_new, 0)
        rec.update(
            status="ok",
            memory=dict(argument_bytes=arg_bytes, output_bytes=out_new + alias,
                        temp_bytes=temp, alias_bytes=alias,
                        peak_bytes=arg_bytes + out_new + temp),
            cost=dict(flops=ops["flops"], bytes_accessed=ops["traffic_bytes"]),
            collectives=ops["collectives"],
            collective_moved_bytes=ops["collective_moved_bytes"],
            top_flops=ops["top_flops"],
            top_traffic=ops["top_traffic"],
            n_chips=n_chips,
            model_params=cfg.param_count(),
            active_params=cfg.active_param_count(),
        )
    except Exception as e:  # noqa: BLE001 -- a failed cell is a bug to record
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 1)

    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--devices", default=None, help="override the 256/512-rank mesh (CI)")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--batch", type=int, default=None, help="override global batch")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="", help="suffix for perf-iteration runs")
    ap.add_argument("--baseline", action="store_true",
                    help="paper-faithful baseline paths (dense attn, seq SSD)")
    ap.add_argument("--lean", action=argparse.BooleanOptionalAction, default=True,
                    help="bf16 optimizer states + bf16 grad accumulator")
    args = ap.parse_args(argv)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in sorted(ARCHS) for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    # one fake world per process, as large as the largest mesh asked for
    _join_fake_world(int(args.devices) if args.devices
                     else 512 if "multipod" in meshes else 256)

    failures = 0
    for arch, shape in cells:
        for mk in meshes:
            rec = run_cell(arch, shape, mk, devices=args.devices,
                           microbatches=args.microbatches, remat=args.remat,
                           out_dir=args.out, batch_override=args.batch,
                           tag=args.tag, baseline=args.baseline, lean=args.lean)
            status = rec["status"]
            line = f"[dryrun] {arch:25s} {shape:12s} {mk:8s} {status}"
            if status == "ok":
                mem = rec["memory"]["peak_bytes"]
                line += (f" peak={mem / 2**30:.2f}GiB/dev ({mem / CARD_BYTES:.0%} of an H100's "
                         f"80 GB) flops={rec['cost']['flops']:.3e} "
                         f"coll={rec['collective_moved_bytes'] / 2**30:.2f}GiB "
                         f"wall={rec['wall_s']}s")
            elif status == "error":
                line += f" {rec['error'][:120]}"
                failures += 1
            print(line, flush=True)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
