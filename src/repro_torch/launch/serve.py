"""Serving entry point of every family: batched prefill + autoregressive decode.

The port of the reference's ``launch/serve.py``: random parameters from a
seed, random prompt tokens (a VLM's also 0.1·N(0, 1) patch embeddings of
(batch, n_patches, d) before them; an audio model's 0.1·N(0, 1) encoder
frames of (batch, n_audio_frames, d) beside them), ONE prefill that builds
the caches (KV rings of capacity ``off + prompt_len + gen``, where ``off``
is a VLM's n_patches and 0 otherwise, clamped to a hybrid's local window;
SSM and RG-LRU states; a decoder layer's cross-attention (k, v) of the
frames), its attention through the CUDA ``flash_attention`` kernel on the
card, once an attention layer (an SSM launches none; Whisper once an
encoder layer, causal off, and once a decoder layer), then ``gen − 1``
decode steps at positions ``off + prompt_len + i``, greedy or sampled.
Prints the prefill time, the decode time and tokens a second; for an MoE
model also the share of (token, choice) entries the prefill's expert
capacity dropped, counted on the card and read once, after the timed steps.

Parameters stay fp32 and every product casts its weight to the activation
dtype, as in every layer of the port: a decode step re-reads and re-casts
all of them.

With ``mesh`` (a host mesh whose ``"model"`` axis is larger than 1, one
process a rank) a model of any family is served tensor-, expert- or
context-parallel: each rank holds its block of every parameter (by default
drawn leaf by leaf from ``sharding.shard.seeded_factory(seed)``, so no
rank ever holds the whole model), its rows of the batch over the data
axes, and its block of each cache (kv heads, or ring slots where the kv
heads do not divide; SSM heads, RG-LRU width); the prefill runs the
kernel on the rank's heads.  Under ``torchrun``, ``--model-parallel`` sets the axis and
``--backend`` names the collective backend (required with more than one
rank); rank 0 prints the times and every rank its peak memory.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b-smoke \
      --batch 4 --prompt-len 32 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \
      --batch 8 --prompt-len 2048 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-2b-smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 \
      --batch 16 --prompt-len 224 --gen 64
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.serve --backend gloo --model-parallel 4 \
      --arch llama4-scout-17b-a16e --layers 2 --batch 4 --prompt-len 256 --gen 8
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.serve --backend gloo --model-parallel 4 \
      --arch recurrentgemma-9b --layers 6 --batch 2 --prompt-len 2556 --gen 8
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from typing import Any, Optional, Union

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.federated.dist import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.world import BACKENDS, init_world
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.sharding import hints
from repro_torch.sharding.shard import local_rows, seeded_factory, shard_params_from


@dataclass
class ServeResult:
    tokens: torch.Tensor  # (batch, gen) int64: the first from the prefill, then one a step
    logits: torch.Tensor  # (gen, batch, V): the logits each token was picked from
    prefill_s: float  # host clock around the prefill, synchronised on the card
    decode_s: float  # the same around the gen − 1 decode steps
    tokens_per_s: float  # (gen − 1)·batch / decode_s
    prefill_launches: int  # flash_attention launches in the prefill (0 for an SSM; Whisper's
    #                        encoder and decoder layers both)
    decode_launches: int  # ... and in the decode steps
    peak_bytes: Optional[int]  # torch.cuda.max_memory_allocated over the run (None on the CPU)
    prefill_drop_share: Optional[float] = None  # MoE: (token, choice) entries dropped / routed


def serve(
    arch: str,
    batch: int = 4,
    prompt_len: int = 32,
    gen: int = 16,
    greedy: bool = True,
    verbose: bool = True,
    *,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    dtype: Optional[str] = None,
    params: Optional[dict] = None,
    prompts: Optional[torch.Tensor] = None,
    patch_embeds: Optional[torch.Tensor] = None,
    audio_frames: Optional[torch.Tensor] = None,
    mesh: Any = None,
    overrides: Optional[dict] = None,
) -> ServeResult:
    """Prefill ``prompts`` (random (batch, prompt_len) tokens unless given;
    a VLM's ``patch_embeds`` (batch, n_patches, d) and an audio model's
    ``audio_frames`` (batch, n_audio_frames, d) likewise) and decode
    ``gen`` tokens a sequence.  ``params`` (the port's layout, on
    ``device``) default to ``Model.init(seed)``; ``dtype`` overrides the
    config's activation dtype; the random prompts, patches, frames and samples
    (``greedy=False``) draw from a ``torch.Generator`` seeded ``seed + 1``.

    With ``mesh``, ``params`` are the rank's blocks (by default
    ``shard_params_from(cfg, seeded_factory(seed), mesh)``), the prompts
    and inputs the whole batch, of which the rank serves its rows; the
    result holds the rank's rows, the logits gathered over the vocab.
    ``overrides`` replaces config fields, e.g. ``n_layers`` and
    ``n_encoder_layers`` to cut the depth (a config too large for the host
    served at its full width)."""
    kw = dict(device=device, seed=seed, dtype=dtype, params=params, prompts=prompts,
              patch_embeds=patch_embeds, audio_frames=audio_frames, mesh=mesh,
              overrides=overrides)
    if mesh is None:
        return _serve(arch, batch, prompt_len, gen, greedy, verbose, **kw)
    with hints.use_mesh(mesh):
        return _serve(arch, batch, prompt_len, gen, greedy, verbose, **kw)


def _serve(arch, batch, prompt_len, gen, greedy, verbose, *, device, seed, dtype, params,
           prompts, patch_embeds, audio_frames, mesh, overrides) -> ServeResult:
    cfg = get_config(arch).replace(**(overrides or {}))
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    dev = resolve_device(device)
    model = build_model(cfg)
    if params is None:
        params = (model.init(seed, dev) if mesh is None
                  else shard_params_from(cfg, seeded_factory(seed), mesh, dev))
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed + 1)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=rng, device=dev)
    else:
        prompts = torch.as_tensor(prompts, device=dev)
        batch, prompt_len = prompts.shape
    fed = {"tokens": prompts}
    off = 0
    if cfg.arch_type == "vlm":
        off = cfg.n_patches
        fed["patch_embeds"] = (
            0.1 * torch.randn((batch, off, cfg.d_model), generator=rng, device=dev)
            if patch_embeds is None else torch.as_tensor(patch_embeds, device=dev))
    if cfg.arch_type == "audio":
        fed["audio_frames"] = (
            0.1 * torch.randn((batch, cfg.n_audio_frames, cfg.d_model), generator=rng, device=dev)
            if audio_frames is None else torch.as_tensor(audio_frames, device=dev))
    if mesh is not None:  # this rank's rows
        fed = {k: local_rows(v, mesh) for k, v in fed.items()}
        batch = fed["tokens"].shape[0]
    prefill = steps.make_prefill_step(cfg, cache_capacity=off + prompt_len + gen)
    decode = steps.make_decode_step(cfg)
    on_card = dev.type == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    def pick(logits: torch.Tensor) -> torch.Tensor:
        if greedy:
            return torch.argmax(logits, dim=-1)[:, None]
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        return torch.multinomial(probs, 1, generator=rng)

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    sync()
    n0 = ops.flash_attention.launches
    drops = moe.DropTally() if cfg.arch_type == "moe" else None
    t0 = time.perf_counter()
    logits, cache = prefill(params, fed, drops)
    tok = pick(logits)
    sync()
    t_prefill = time.perf_counter() - t0
    n1 = ops.flash_attention.launches

    out, seen = [tok], [logits]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode(params, cache, tok, off + prompt_len + i)
        tok = pick(logits)
        out.append(tok)
        seen.append(logits)
    toks = torch.cat(out, dim=1)
    sync()
    t_decode = time.perf_counter() - t0
    res = ServeResult(
        tokens=toks, logits=torch.stack(seen), prefill_s=t_prefill, decode_s=t_decode,
        tokens_per_s=(gen - 1) * batch / max(t_decode, 1e-9),
        prefill_launches=n1 - n0, decode_launches=ops.flash_attention.launches - n1,
        peak_bytes=torch.cuda.max_memory_allocated(dev) if on_card else None,
        prefill_drop_share=drops.share() if drops is not None else None,
    )
    if verbose and (mesh is None or dist.get_rank() == 0):
        dropped = ("" if res.prefill_drop_share is None
                   else f"  prefill drop share {res.prefill_drop_share:.4f}")
        print(f"[{arch}] prefill({batch}x{prompt_len}): {t_prefill * 1e3:.1f}ms  "
              f"decode {gen - 1} steps: {t_decode * 1e3:.1f}ms "
              f"({res.tokens_per_s:.1f} tok/s)  on {dev}{dropped}")
        print("generated:", toks[0].tolist())
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None, help="cut the config's depth")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="collective backend when torchrun starts more than one rank")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="size of the mesh's 'model' axis (the rest of the world is 'data')")
    args = ap.parse_args()
    device, mesh = args.device, None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if args.backend is None:
            ap.error("more than one rank: name the collective backend with --backend")
        device = init_world(args.backend, args.device)
        mesh = make_host_mesh(args.model_parallel, device_type=device.type)
    elif args.model_parallel > 1:
        ap.error("--model-parallel > 1 needs one rank a model block: start the ranks with "
                 "torchrun")
    try:
        res = serve(args.arch, args.batch, args.prompt_len, args.gen, device=device, mesh=mesh,
                    overrides=None if args.layers is None else {"n_layers": args.layers})
        if mesh is not None:
            peak = "n/a" if res.peak_bytes is None else f"{res.peak_bytes / 2**30:.3f} GiB"
            print(f"[rank {dist.get_rank()}] peak memory {peak}  flash launches "
                  f"prefill {res.prefill_launches} decode {res.decode_launches}", flush=True)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
