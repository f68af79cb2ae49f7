"""Serve a batch of requests against any architecture family, on the port.

Exercises the inference substrate: batched prefill (attention through the
flash kernel on the card), ring-buffer KV caches, SSM/RG-LRU
constant-memory decode, sliding windows, enc-dec cross caches.

    PYTHONPATH=src python examples_torch/serve_demo.py [--device cpu] [--dtype float32]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.federated.dist import resolve_device
from repro_torch.launch.serve import serve
from repro_torch.models import build_model
from repro_torch.tree import tree_map

ARCHS = (
    "qwen2-7b-smoke",  # dense GQA + ring KV cache
    "mamba2-1.3b-smoke",  # attention-free O(1)-state decode
    "recurrentgemma-9b-smoke",  # hybrid RG-LRU + local attention
    "whisper-large-v3-smoke",  # enc-dec with cross-attention cache
)


def draw(cfg, batch: int, prompt_len: int, seed: int):
    """What ``serve`` would draw from ``seed`` on the CPU, drawn on the host
    whatever the device: (the weights, the prompts (batch, prompt_len), a
    VLM's patches or an audio model's frames by name)."""
    params = build_model(cfg).init(seed, "cpu")
    gen = torch.Generator()
    gen.manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen)
    extra = {}
    if cfg.arch_type == "vlm":
        extra["patch_embeds"] = 0.1 * torch.randn((batch, cfg.n_patches, cfg.d_model),
                                                  generator=gen)
    if cfg.arch_type == "audio":
        extra["audio_frames"] = 0.1 * torch.randn((batch, cfg.n_audio_frames, cfg.d_model),
                                                  generator=gen)
    return params, prompts, extra


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None, help="activation dtype (default: the config's)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}
    for arch in ARCHS:
        params, prompts, extra = draw(get_config(arch), args.batch, args.prompt_len, args.seed)
        res = serve(arch, gen=args.gen, device=dev, dtype=args.dtype,
                    params=tree_map(lambda t: t.to(dev), params), prompts=prompts.to(dev),
                    **{k: v.to(dev) for k, v in extra.items()})
        print(f"[{arch}] flash launches: prefill {res.prefill_launches}, "
              f"decode {res.decode_launches}")
        out[arch] = {"tokens": res.tokens.cpu().numpy(),
                     "logits": res.logits.float().cpu().numpy(),
                     "prefill_ms": res.prefill_s * 1e3, "decode_ms": res.decode_s * 1e3,
                     "tokens_per_s": res.tokens_per_s,
                     "prefill_launches": res.prefill_launches,
                     "decode_launches": res.decode_launches}
    return out


if __name__ == "__main__":
    main()
