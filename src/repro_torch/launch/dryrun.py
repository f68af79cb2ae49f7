"""The dry run: one rank of the production mesh runs its program on the card.

The port's counterpart of the reference's ``launch/dryrun.py``.  The
reference lowers and compiles every (arch × shape × mesh) combination for
the 16 × 16 TPU mesh (and the 2 × 16 × 16 multi-pod one) on simulated
host devices, and reads each program's per-device memory, FLOPs, bytes
and collectives from XLA.  The port has no compiler to ask: one process
acts as rank 0 of that mesh over a fake world
(:func:`repro_torch.launch.mesh.make_dryrun_mesh`: 256 or 512 ranks, every
collective a no-op) and runs the real step — train, prefill, decode or the
Fed3R statistics pass — on the rank's blocks at full width and depth, once
cold and once warm.  It records, per combination:

* the decisions, copied from the reference: FSDP (parameters over the data
  axes too) where the TP-only parameters pass ``FSDP_TRAIN_THRESHOLD``
  (fp32 parameters and gradients, train) or ``FSDP_INFERENCE_THRESHOLD``
  (bf16 parameters, serving); the train step's microbatches; the
  sliding-window variant of ``long_500k``; Whisper's ``long_500k`` skipped;
* ``argument_size_in_bytes``: the rank's parameters, inputs and caches,
  counted on the meta device from the specs (``sharding/specs.py``);
* ``per_device_bytes``: ``torch.cuda.max_memory_allocated`` over the warm
  step, arguments included; ``fits_hbm`` against the card's own memory;
* the collectives the rank issued (``sharding.hints.census``) and their
  wire bytes by the reference's ring factors
  (:mod:`repro_torch.launch.hlo_analysis`), priced at the slowest link its
  groups cross (``launch/mesh.py``: every group of the row-major
  production layout spans nodes);
* the whole program's FLOPs (``torch.utils.flop_counter.FlopCounterMode``)
  and bytes (each non-view aten op's inputs and outputs), each plus the
  hand kernels' own counts (``kernels/build.py::work_meter``; a ctypes
  launch is invisible to PyTorch's dispatcher), taken over the cold step,
  and the three-term roofline on the card's data-sheet figures; eager
  PyTorch hides no loop body, so there is no depth extrapolation;
* ``setup_s`` (weights and inputs made), ``step_s`` (the warm step) and
  ``total_s``.

In a fake world no collective moves data, so a buffer a collective would
fill keeps what it held: values past a collective are not meaningful
(``collective_values`` says so), and nothing here reads one on the host.
On the card the warm step runs under ``set_sync_debug_mode("error")``, so
a step that would branch on a device value raises instead of adapting.
Any combination that fails is recorded with ``status: "error"`` and its
traceback, and the run exits 1, as the reference's does.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
  python -m repro_torch.launch.dryrun --all --multi-pod --skip-roofline
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape prefill_32k --kind fed3r
  python -m repro_torch.launch.dryrun --arch qwen2-7b-smoke --device cpu  (smoke width)
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import time
import traceback
from typing import Any, Dict, List, Optional, Union

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config, load_all
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import fed3r
from repro_torch.federated.dist import resolve_device
from repro_torch.kernels import build, ops
from repro_torch.launch import hlo_analysis, steps
from repro_torch.launch.flops import model_flops, param_breakdown
from repro_torch.launch.mesh import (
    FAKE_BACKEND,
    HBM_BW,
    PEAK_FLOPS_BF16,
    link_bw,
    make_dryrun_mesh,
    n_chips,
)
from repro_torch.launch.shapes import TensorSpec, abstract_params, input_specs, variant_for
from repro_torch.models import model as model_lib
from repro_torch.sharding import hints
from repro_torch.sharding.shard import leaf_specs, seeded_factory, shard_params_from
from repro_torch.sharding.specs import (
    PartitionSpec,
    batch_specs,
    cache_specs,
    map_with_path,
    stats_specs,
)
from repro_torch.tree import tree_leaves

FED3R_N_CLASSES = 2028  # Landmarks-scale classifier head (paper Table 4)
FSDP_INFERENCE_THRESHOLD = 8e9  # bytes of bf16 params per chip under TP-only
FSDP_TRAIN_THRESHOLD = 12e9  # bytes of fp32 params+grads per chip under TP-only
MICROBATCH_ACT_BUDGET = 4e9  # target per-device activation bytes (train)
SKIP_REASON = "long_500k n/a for full-attn enc-dec (see DESIGN.md)"
VALUES_NOTE = "not meaningful: a fake world's collectives move no data"
WEIGHT_SEED = 0  # sharding/shard.py::seeded_factory's seed of the rank's blocks

_ACT_FACTOR = {"dense": 6, "vlm": 6, "audio": 6, "moe": 12, "ssm": 14, "hybrid": 8}


def _pick_microbatches(cfg: ModelConfig, shape: ShapeConfig, da_size: int) -> int:
    if shape.kind != "train":
        return 1
    b_pd = max(shape.global_batch // da_size, 1)
    tokens_pd = shape.global_batch * shape.seq_len / da_size
    n_l = cfg.n_layers + cfg.n_encoder_layers
    act = n_l * tokens_pd * cfg.d_model * 2 * _ACT_FACTOR.get(cfg.arch_type, 6)
    m = 1
    while act / m > MICROBATCH_ACT_BUDGET and m < b_pd:
        m *= 2
    while b_pd % m != 0:
        m //= 2
    return max(m, 1)


def _mesh_name(sizes: Dict[str, int]) -> str:
    return "x".join(str(s) for s in sizes.values())


def _da_size(sizes: Dict[str, int]) -> int:
    return math.prod(s for a, s in sizes.items() if a != "model")


@functools.lru_cache(maxsize=64)
def _n_params(cfg: ModelConfig) -> int:
    return sum(t.numel() for t in tree_leaves(abstract_params(cfg)))


def fsdp_choice(cfg: ModelConfig, kind: str, model: int) -> bool:
    """The reference's FSDP decision: train when 2 · fp32 parameters over
    the "model" axis pass FSDP_TRAIN_THRESHOLD, otherwise (bf16 serving
    parameters) when they pass FSDP_INFERENCE_THRESHOLD."""
    n = _n_params(cfg)
    if kind == "train":
        return 2 * n * 4 / model > FSDP_TRAIN_THRESHOLD
    return n * 2 / model > FSDP_INFERENCE_THRESHOLD


def plan(arch: str, shape: Union[str, ShapeConfig], sizes: Dict[str, int],
         kind_override: Optional[str] = None, overrides: Optional[dict] = None,
         fsdp: Optional[bool] = None) -> Dict[str, Any]:
    """The decisions of one combination: its record's first keys (``arch``,
    ``shape``, ``mesh``, ``kind``, ``status`` "pending" or "skipped" with
    ``skip_reason``, ``variant``, ``num_microbatches``, ``remat_block_size``,
    ``fsdp``) and, under ``"cfg"``, the config run (None when skipped).
    ``overrides`` replace config fields (a depth cut); ``fsdp`` forces the
    layout."""
    load_all()
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    cfg0 = get_config(arch)
    if overrides:
        cfg0 = cfg0.replace(**overrides)
    cfg = variant_for(cfg0, shape)
    kind = kind_override or shape.kind
    rec: Dict[str, Any] = {"arch": arch, "shape": shape.name, "mesh": _mesh_name(sizes),
                           "kind": kind, "status": "skipped" if cfg is None else "pending"}
    if cfg is None:
        rec["skip_reason"] = SKIP_REASON
        return dict(rec, cfg=None)
    if cfg.sliding_window and shape.name == "long_500k":
        rec["variant"] = f"sliding_window={cfg.sliding_window}"
    rec["num_microbatches"] = _pick_microbatches(cfg, shape, _da_size(sizes))
    rec["remat_block_size"] = cfg.remat_block_size
    rec["fsdp"] = bool(fsdp_choice(cfg, kind, sizes["model"]) if fsdp is None else fsdp)
    return dict(rec, cfg=cfg)


# ---------------------------------------------------------------------------
# the rank's arguments: their specs, bytes and tensors
# ---------------------------------------------------------------------------


def _fed3r_batch(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    batch = dict(input_specs(cfg, dataclasses.replace(shape, kind="prefill"))["batch"])
    batch["class_labels"] = TensorSpec((shape.global_batch,), torch.int32)
    return batch


def _block(spec: PartitionSpec, leaf: TensorSpec, sizes: Dict[str, int]) -> TensorSpec:
    """The block of ``leaf`` a rank holds under ``spec``."""
    idx = spec.index(tuple(leaf.shape), {a: 0 for a in sizes}, sizes)
    return TensorSpec(tuple(len(range(*s.indices(n))) for s, n in zip(idx, leaf.shape)),
                      leaf.dtype)


def _blocks(tree: Any, specs: Any, sizes: Dict[str, int]) -> Dict[tuple, TensorSpec]:
    """{key path: the block a rank holds} of a tree of whole-shape leaves
    under a spec tree of the same structure."""
    flat: Dict[tuple, PartitionSpec] = {}
    map_with_path(specs, lambda path, s: flat.__setitem__(path, s))
    out: Dict[tuple, TensorSpec] = {}
    map_with_path(tree, lambda path, leaf: out.__setitem__(path, _block(flat[path], leaf, sizes)))
    return out


def _nbytes(specs: Dict[tuple, TensorSpec]) -> int:
    return sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype).element_size()
               for s in specs.values())


def rank_specs(cfg: ModelConfig, kind: str, shape: ShapeConfig, sizes: Dict[str, int],
               fsdp: bool) -> Dict[str, Dict[tuple, TensorSpec]]:
    """The blocks of the step's arguments a rank holds, by argument:
    ``params`` (fp32 to train, bf16 to serve), then ``batch``, ``cache``,
    ``token`` and ``pos`` or ``stats`` (paths "0", "1", "2": A, b, n) as
    the step takes them; each {key path: TensorSpec of the block}."""
    da = tuple(a for a in sizes if a != "model")
    meta, flat = leaf_specs(cfg, sizes, fsdp)
    dt = torch.float32 if kind == "train" else torch.bfloat16
    out = {"params": {}}
    map_with_path(meta, lambda path, leaf: out["params"].__setitem__(
        path, _block(flat[path], TensorSpec(tuple(leaf.shape), dt), sizes)))
    if kind in ("train", "prefill"):
        batch = input_specs(cfg, shape)["batch"]
        out["batch"] = _blocks(batch, batch_specs(cfg, batch, da, sizes), sizes)
    elif kind == "decode":
        spec = input_specs(cfg, shape)
        out["cache"] = _blocks(spec["cache"], cache_specs(cfg, spec["cache"], da, sizes), sizes)
        token = {"token": spec["token"]}
        out["token"] = _blocks(token, batch_specs(cfg, token, da, sizes), sizes)
        out["pos"] = {("pos",): spec["pos"]}
    elif kind == "fed3r":
        batch = _fed3r_batch(cfg, shape)
        out["batch"] = _blocks(batch, batch_specs(cfg, batch, da, sizes), sizes)
        stats = fed3r.Fed3RStats(
            A=TensorSpec((cfg.d_feat, cfg.d_feat), torch.float32),
            b=TensorSpec((cfg.d_feat, FED3R_N_CLASSES), torch.float32),
            n=TensorSpec((), torch.float32))
        row = PartitionSpec("model") if stats_specs(cfg.d_feat, sizes["model"]).A.axes \
            else PartitionSpec()
        out["stats"] = _blocks(stats, fed3r.Fed3RStats(A=row, b=row, n=PartitionSpec()), sizes)
    else:
        raise ValueError(f"unknown step kind {kind!r}")
    return out


def argument_bytes(cfg: ModelConfig, kind: str, shape: ShapeConfig, sizes: Dict[str, int],
                   fsdp: bool) -> int:
    """The bytes of a rank's step arguments (:func:`rank_specs`), counted
    on the meta device."""
    return sum(_nbytes(v) for v in rank_specs(cfg, kind, shape, sizes, fsdp).values())


def _batch(specs: Dict[tuple, TensorSpec], cfg: ModelConfig, gen: torch.Generator,
           dev: torch.device) -> Dict[str, torch.Tensor]:
    """Random batch blocks of ``specs``: token ids below the vocab, class
    labels below FED3R_N_CLASSES, N(0, 1) frames and patches."""
    out = {}
    for (name,), s in specs.items():
        if s.dtype.is_floating_point:
            out[name] = torch.randn(s.shape, generator=gen, device=dev).to(s.dtype)
        else:
            high = FED3R_N_CLASSES if name == "class_labels" else cfg.vocab_size
            out[name] = torch.randint(0, high, s.shape, generator=gen, device=dev,
                                      dtype=s.dtype)
    return out


def rank_arguments(cfg: ModelConfig, kind: str, shape: ShapeConfig, mesh: Any,
                   dev: torch.device, fsdp: bool, seed: int = 1) -> List[Any]:
    """The rank's step arguments on ``dev``: its blocks of
    ``seeded_factory(WEIGHT_SEED)``'s weights (bf16 to serve) and random
    inputs and caches from ``seed`` of the shapes :func:`rank_specs` gives
    (the caches empty, as ``make_cache`` makes them)."""
    sizes = hints.axis_sizes(mesh)
    specs = rank_specs(cfg, kind, shape, sizes, fsdp)
    make = seeded_factory(WEIGHT_SEED)
    factory = make if kind == "train" else (lambda *a: make(*a).to(torch.bfloat16))
    params = shard_params_from(cfg, factory, mesh, dev, fsdp=fsdp)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 7919 * dist.get_rank())
    if kind in ("train", "prefill", "fed3r"):
        batch = _batch(specs["batch"], cfg, gen, dev)
        if kind != "fed3r":
            return [params, batch]
        rows = specs["stats"][("0",)].shape[0]  # A's rows: the model rank's, or all
        stats = fed3r.Fed3RStats(
            A=torch.zeros((rows, cfg.d_feat), dtype=torch.float32, device=dev),
            b=torch.zeros((rows, FED3R_N_CLASSES), dtype=torch.float32, device=dev),
            n=torch.zeros((), dtype=torch.float32, device=dev))
        return [params, stats, batch]
    token = _batch(specs["token"], cfg, gen, dev)["token"]
    with hints.use_mesh(mesh):  # the rank's block of every cache leaf
        cache = model_lib.make_cache(cfg, token.shape[0], shape.seq_len, dev)
    return [params, cache, token, shape.seq_len - 1]


def _step(cfg: ModelConfig, kind: str, shape: ShapeConfig, mesh: Any, M: int):
    """The step function of ``kind``, and whether it runs under a gradient."""
    if kind == "train":
        return steps.make_train_step(cfg, lr=1e-2, num_microbatches=M), True
    if kind == "prefill":
        cap = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
        return steps.make_prefill_step(cfg, cache_capacity=cap), False
    if kind == "decode":
        return steps.make_decode_step(cfg), False
    return steps.make_fed3r_stats_step(cfg, FED3R_N_CLASSES, aggregation="psum", mesh=mesh), False


# ---------------------------------------------------------------------------
# counting the program
# ---------------------------------------------------------------------------


_UNCOUNTED = ("empty", "empty_strided", "empty_like")  # allocate, move nothing


class _ByteCounter(TorchDispatchMode):
    """The bytes of every non-view aten op's tensor inputs and outputs (the
    collectives' c10d ops, bare allocations and meta tensors left out: a
    spec built on the meta device inside the step moves no byte)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.namespace in ("c10d", "_c10d_functional")
                or func.overloadpacket.__name__ in _UNCOUNTED):
            leaves, _ = tree_flatten((args, kwargs, out))
            self.bytes += sum(t.numel() * t.element_size() for t in leaves
                              if isinstance(t, torch.Tensor) and not t.is_meta)
        return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> Dict[str, int]:
    return {"flash_attention": ops.flash_attention.launches,
            "fed3r_stats": ops.fed3r_stats.launches}


def rank_program(cfg: ModelConfig, kind: str, shape: ShapeConfig, mesh: Any,
                 dev: torch.device, fsdp: bool, M: int, count: bool = True) -> Dict[str, Any]:
    """Build the rank's arguments, run the step once cold (with ``count``,
    under FLOP and byte counters) and once warm (timed; its peak memory;
    on the card in a fake world under sync-debug "error"), each under a
    census.  Returns
    ``setup_s``, ``step_s``, ``cold_s``, ``peak_bytes`` (None off the
    card), ``census`` (the warm step's records; the cold step's must equal
    them), ``launches`` (the warm step's kernel launches), ``built_bytes``
    (the arguments as made) and with ``count`` ``flops`` and ``bytes``."""
    out: Dict[str, Any] = {}
    _sync(dev)
    t0 = time.perf_counter()
    args = rank_arguments(cfg, kind, shape, mesh, dev, fsdp)
    # decode's pos is a Python int, an int32 scalar in the reference's arguments
    out["built_bytes"] = sum(t.numel() * t.element_size() for t in tree_leaves(args)
                             if isinstance(t, torch.Tensor)) + 4 * (kind == "decode")
    step, grad = _step(cfg, kind, shape, mesh, M)
    _sync(dev)
    out["setup_s"] = time.perf_counter() - t0

    def run():
        with hints.use_mesh(mesh, fsdp=fsdp), torch.set_grad_enabled(grad):
            res = step(*args)
        _sync(dev)
        return res

    t0 = time.perf_counter()
    with hints.census() as cold:
        if count:
            with build.work_meter() as kernels, FlopCounterMode(display=False) as flops, \
                    _ByteCounter() as nbytes:
                res = run()
            out["flops"] = float(flops.get_total_flops()) + kernels["flops"]
            out["bytes"] = float(nbytes.bytes) + kernels["bytes"]
        else:
            res = run()
    out["cold_s"] = time.perf_counter() - t0
    del res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    before = _launches()
    # a fake world's collectives return at once: any host sync left in the
    # step reads a device value (a real gloo world stages through the host)
    gate = dev.type == "cuda" and dist.get_backend() == FAKE_BACKEND
    t0 = time.perf_counter()
    with hints.census() as warm:
        if gate:
            torch.cuda.set_sync_debug_mode("error")
        try:
            res = run()
        finally:
            if gate:
                torch.cuda.set_sync_debug_mode("default")
    out["step_s"] = time.perf_counter() - t0
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    out["launches"] = {k: v - before[k] for k, v in _launches().items()}
    if list(cold) != list(warm):
        raise RuntimeError(f"the cold and warm steps issued different collectives: "
                           f"{len(cold)} and {len(warm)}")
    out["census"] = list(warm)
    del res, args
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# one combination, and the command line
# ---------------------------------------------------------------------------


def lower_one(
    arch: str,
    shape: str,
    *,
    mesh: Any,
    kind_override: Optional[str] = None,
    skip_roofline: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """Run rank ``mesh``'s program of one combination; return its record.
    ``mesh`` is :func:`~repro_torch.launch.mesh.make_dryrun_mesh`'s."""
    t0 = time.time()
    dev = resolve_device(device)
    sizes = hints.axis_sizes(mesh)
    shape_cfg = INPUT_SHAPES[shape]
    rec = plan(arch, shape_cfg, sizes, kind_override)
    cfg = rec.pop("cfg")
    if cfg is None:
        return rec
    kind, M, use_fsdp = rec["kind"], rec["num_microbatches"], rec["fsdp"]
    rec["argument_size_in_bytes"] = argument_bytes(cfg, kind, shape_cfg, sizes, use_fsdp)
    prog = rank_program(cfg, kind, shape_cfg, mesh, dev, use_fsdp, M, count=not skip_roofline)
    rec["argument_size_in_bytes_built"] = prog["built_bytes"]
    rec["setup_s"] = round(prog["setup_s"], 3)
    rec["step_s"] = round(prog["step_s"], 4)
    rec["cold_s"] = round(prog["cold_s"], 3)
    rec["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    per_dev = prog["peak_bytes"]
    rec["per_device_bytes"] = per_dev
    rec["per_device_gb"] = None if per_dev is None else round(per_dev / 1e9, 2)
    rec["fits_hbm"] = None if per_dev is None else bool(
        per_dev <= torch.cuda.get_device_properties(dev).total_memory)
    rec["launches"] = prog["launches"]
    rec["collective_values"] = VALUES_NOTE
    coll = hlo_analysis.collective_stats(prog["census"])
    rec["collectives"] = {k: int(v) for k, v in coll.counts.items()}
    rec["collective_wire_by_kind"] = {k: float(v) for k, v in coll.wire_bytes.items()}
    rec["collective_wire_bytes_per_chip"] = coll.total_wire_bytes
    if not skip_roofline:
        cross = any(r.cross_node for r in prog["census"])
        rt = hlo_analysis.roofline_terms(
            prog["flops"], prog["bytes"], coll.total_wire_bytes, n_chips(mesh),
            peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW, ici_bw=link_bw(cross))
        rec["hlo_flops_global"] = rt.hlo_flops_global
        rec["hlo_bytes_global"] = rt.hlo_bytes_global
        rec["roofline"] = {"compute_s": rt.compute_s, "memory_s": rt.memory_s,
                           "collective_s": rt.collective_s, "dominant": rt.dominant,
                           "link_bytes_per_s": link_bw(cross)}
        meta = abstract_params(cfg)
        mf = model_flops(cfg, shape_cfg, meta)
        rec["model_flops"] = mf
        rec["useful_flops_ratio"] = mf / rt.hlo_flops_global if rt.hlo_flops_global else None
        rec["params"] = param_breakdown(cfg, meta)
    rec["status"] = "ok"
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def _line(rec: Dict[str, Any]) -> str:
    status = rec["status"]
    msg = f"[{status:7s}] {rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s}"
    if status == "ok":
        msg += (f" fsdp={rec['fsdp']!s:5s} M={rec['num_microbatches']:<3d}"
                f" step={rec['step_s']:8.3f}s mem={rec.get('per_device_gb')}GB"
                f" fits={rec.get('fits_hbm')}"
                f" coll={json.dumps(rec['collectives'], sort_keys=True)}")
        if "roofline" in rec:
            r = rec["roofline"]
            msg += (f" compute={r['compute_s'] * 1e3:9.3f}ms memory={r['memory_s'] * 1e3:9.3f}ms"
                    f" coll={r['collective_s'] * 1e3:9.3f}ms dom={r['dominant']}")
    elif status == "error":
        msg += f" {rec['error'][:140]}"
    return msg


def main(argv: Optional[List[str]] = None) -> int:
    load_all()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="an assigned arch, any config name, or all")
    ap.add_argument("--shape", choices=list(INPUT_SHAPES) + ["all"], default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--kind", default=None, choices=[None, "fed3r"],
                    help="override the step kind (fed3r = statistics pass)")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--all", action="store_true", help="arch=all shape=all")
    ap.add_argument("--skip-roofline", action="store_true",
                    help="no FLOP and byte counters: the memory and collectives only")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or args.arch == "all") else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape == "all") else [args.shape]
    dev = resolve_device(args.device)
    mesh = make_dryrun_mesh(multi_pod=args.multi_pod, device_type=dev.type)
    print(f"mesh: {mesh} (rank 0 of a fake world: no collective moves data)", flush=True)
    n_ok = n_fail = n_skip = 0
    try:
        for arch in archs:
            for shape in shapes:
                try:
                    rec = lower_one(arch, shape, mesh=mesh, kind_override=args.kind,
                                    skip_roofline=args.skip_roofline, device=dev)
                except Exception as e:  # noqa: BLE001 — recorded; the run exits 1
                    rec = {"arch": arch, "shape": shape, "mesh": _mesh_name(hints.axis_sizes(mesh)),
                           "kind": args.kind or INPUT_SHAPES[shape].kind, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    if dev.type == "cuda":
                        torch.cuda.empty_cache()
                n_ok += rec["status"] == "ok"
                n_fail += rec["status"] == "error"
                n_skip += rec["status"] == "skipped"
                print(_line(rec), flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    finally:
        dist.destroy_process_group()
    print(f"done: ok={n_ok} failed={n_fail} skipped={n_skip}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
