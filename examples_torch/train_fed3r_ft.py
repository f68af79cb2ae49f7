"""End-to-end driver on the port: FED3R + fine-tuning of a transformer backbone.

The full paper pipeline on a real model: (1) one statistics pass over every
client through the frozen backbone — closed-form classifier (one
``fed3r_stats`` launch a client slot on the card); (2) federated
fine-tuning of the backbone with the classifier FIXED (FT-FEAT, the paper's
most robust cross-device variant).

Default backbone is the reduced proxy for CPU speed; pass
``--arch fed3r-mnv2-proxy`` for the ~100M-parameter paper-scale extractor
(d=1280 feature space, as MobileNetV2) — same code, longer wall time.  The
weights and the token data are drawn on the host, so a run on the card and
one on the CPU start from the same numbers.

    PYTHONPATH=src python examples_torch/train_fed3r_ft.py --rounds 100 [--device cpu]
"""
import argparse

from repro_torch.launch.train import run


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="fed3r-mnv2-proxy-smoke")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--ft-strategy", default="feat", choices=["full", "lp", "feat"])
    ap.add_argument("--no-fed3r-init", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    log = run(args.arch, rounds=args.rounds, ft_strategy=args.ft_strategy,
              use_fed3r_init=not args.no_fed3r_init, device=args.device)
    ft = log.get("ft", {"rounds": [], "ft_acc": [], "round_ms": [], "n_test": None})
    print("\nsummary:")
    print(f"  FED3R closed-form accuracy : {log.get('fed3r_acc')}")
    if ft["ft_acc"]:
        print(f"  after {ft['rounds'][-1]} FT rounds      : {ft['ft_acc'][-1]:.4f}")
    return {"fed3r_acc": log.get("fed3r_acc"), "rounds": ft["rounds"], "ft_acc": ft["ft_acc"],
            "round_ms": ft["round_ms"], "n_test": log.get("n_test", ft["n_test"])}


if __name__ == "__main__":
    main()
