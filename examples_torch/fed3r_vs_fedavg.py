"""FED3R vs gradient FL under pathological heterogeneity (paper Fig. 2), on the port.

Compares accuracy-vs-rounds and the App. D/E cost meters for FED3R,
FED3R-RF and the FedAvg/FedAvgM/Scaffold linear-probe baselines on the
same one-class-per-client federation.  The FED3R-RF row prices its D = 1024
random features (its ``CostModel`` carries D); on the card FED3R runs the
``fed3r_stats`` kernel a client, FED3R-RF the ``rff`` kernel a shard and
the test map first.

    PYTHONPATH=src python examples_torch/fed3r_vs_fedavg.py [--device cpu] [--rounds 100]
"""
import argparse

import torch

from repro_torch.configs.base import Fed3RConfig, FederatedConfig
from repro_torch.core.random_features import RFFParams, rff_init
from repro_torch.data.pipeline import make_federated_features
from repro_torch.federated.costs import CostModel
from repro_torch.federated.dist import resolve_device
from repro_torch.federated.fed3r_driver import run_fed3r
from repro_torch.federated.simulator import linear_head_task, run_federated

D, C, K = 48, 20, 100


def draw_rff(d: int, n_features: int, sigma: float, seed: int) -> RFFParams:
    """The server's (Ω, β), drawn on the host as ``run_fed3r`` draws them on
    the CPU (a ``torch.Generator`` seeded ``seed + 101``)."""
    gen = torch.Generator()
    gen.manual_seed(seed + 101)
    return rff_init(gen, d, n_features, sigma)


def draw_head(d: int, n_classes: int) -> torch.Tensor:
    """The LP baselines' first head, 0.01·N(0, 1), drawn on the host as
    ``linear_head_task`` draws it on the CPU (seed 0)."""
    gen = torch.Generator()
    gen.manual_seed(0)
    return 0.01 * torch.randn((d, n_classes), generator=gen)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=100, help="the LP baselines' rounds")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    R = args.rounds

    fed, test = make_federated_features(seed=0, n=12_000, d=D, n_classes=C, n_clients=K,
                                        alpha=0.0, noise=2.5, device="cpu")
    avg_nk = fed.client_sizes().mean()
    rows = {}
    print(f"{'method':14s} {'rounds':>7s} {'final acc':>9s} {'upload/client':>14s} "
          f"{'GFLOPs/client':>14s}")

    # --- FED3R family ------------------------------------------------------
    for name, rf in (("fed3r", 0), ("fed3r-rf", 1024)):
        f3 = Fed3RConfig(n_classes=C, n_random_features=rf, rff_sigma=12.0)
        fc = FederatedConfig(n_clients=K, clients_per_round=10, n_rounds=100)
        params = None
        if rf:
            host = draw_rff(D, rf, f3.rff_sigma, fc.seed)
            params = RFFParams(*(t.to(dev) for t in host))
        _, _, h = run_fed3r(fed, test.features, test.labels, f3, fc, eval_every=1,
                            rff_params=params, device=dev)
        cm = CostModel(b=2.22e6, d=D, C=C, E=1, D=rf)
        up = cm.comm_per_client(name)["up"] * 4
        fl = cm.comp_per_client(name, avg_nk)
        rows[name] = {"rounds": h.rounds[-1], "acc": h.accuracy[-1], "up_bytes": up, "flops": fl}
        print(f"{name:14s} {h.rounds[-1]:7d} {h.accuracy[-1]:9.4f} "
              f"{up/1e6:11.1f}MB {fl/1e9:13.2f}")

    # --- gradient LP baselines ---------------------------------------------
    cm = CostModel(b=2.22e6, d=D, C=C, E=1)
    for alg, smom in (("fedavg", 0.0), ("fedavgm", 0.9), ("scaffold", 0.0)):
        task = linear_head_task(D, C, test.features, test.labels, W_init=draw_head(D, C),
                                device=dev)
        fc = FederatedConfig(n_clients=K, clients_per_round=10, n_rounds=R, local_epochs=1,
                             local_batch_size=32, client_lr=0.1, algorithm=alg,
                             server_momentum=smom)
        _, h = run_federated(task, fed, fc, eval_every=10)
        lp = ("fedavg" if alg != "scaffold" else "scaffold") + "-lp"
        up = cm.comm_per_client(lp)["up"] * 4 * R  # pays every round
        fl = cm.cumulative_comp_flops_per_client(lp, R, 10, K, avg_nk)[-1]
        rows[alg + "-lp"] = {"rounds": R, "acc": h.accuracy[-1], "up_bytes": up, "flops": fl}
        print(f"{alg+'-lp':14s} {R:7d} {h.accuracy[-1]:9.4f} "
              f"{up/1e6:11.1f}MB {fl/1e9:13.2f}")
    return {"rows": rows, "n_test": int(test.labels.shape[0])}


if __name__ == "__main__":
    main()
