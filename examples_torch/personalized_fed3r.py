"""Personalized FED3R — per-tenant closed-form heads over the global state, on the port.

The global ridge head is immune to heterogeneity because it ignores
per-client structure; cross-device serving wants the opposite — per-USER
heads.  The closed form makes both available from the SAME statistics:

    W_k = (A + α_k·A_k + λI)⁻¹ (b + α_k·b_k)

is a rank-n_k Cholesky update of the factored global state, so a whole
cohort of personalized heads solves in ONE engine call
(repro_torch.federated.personalization; its refit one
``batched_chol_gram`` launch on the card), with each tenant's α_k selected
inside that call by a closed-form held-out score (α = 0 falls back to the
global head, bitwise).

The scenario: tenants DISAGREE on labels — every other tenant swaps two
class labels.  The global head averages the conflicting concepts away; the
personalized closed form recovers each tenant's own mapping, and the α
sweep keeps aligned tenants on the (bitwise) global head.

    PYTHONPATH=src python examples_torch/personalized_fed3r.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import fed3r
from repro_torch.data.pipeline import make_federated_features, pack_personal_cohort
from repro_torch.federated.dist import resolve_device
from repro_torch.federated.personalization import (
    PersonalizationEngine,
    PersonalizeConfig,
    ReferencePersonalizedLoop,
    cohort_stats,
)

D, C, LAM, K = 32, 10, 1e-2, 16


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    fed, _ = make_federated_features(seed=3, n=6000, d=D, n_classes=C, n_clients=K, alpha=0.3,
                                     noise=2.0, device="cpu")

    # every other tenant relabels two classes: its concept differs from the
    # federation's.  Half of each tenant's data builds statistics, half evaluates.
    clients, eval_xy, drifted = [], [], []
    for k in range(K):
        cd = fed.client(k)
        labels = np.asarray(cd.labels)
        if k % 2 == 1:
            rng = np.random.default_rng((3, k))
            i, j = rng.choice(C, size=2, replace=False)
            perm = np.arange(C)
            perm[[i, j]] = perm[[j, i]]
            labels = perm[labels]
            drifted.append(k)
        half = max(cd.n // 2, 1)
        clients.append((cd.features[:half], labels[:half]))
        eval_xy.append((cd.features[half:], labels[half:]))
    packed = pack_personal_cohort(clients, client_ids=list(range(K)))

    # the shared factored base: L Lᵀ = A + λI over ALL tenants' statistics
    stats = cohort_stats(packed, C, device=dev)
    eye = torch.eye(D, dtype=torch.float32, device=dev)
    # (row-major, as the engine's kernels read it: linalg returns a
    # column-major factor)
    L = torch.linalg.cholesky(stats.A + LAM * eye).contiguous()
    state = fed3r.Fed3RFactored(L=L, b=stats.b)
    W_global = fed3r.factored_solution(state)

    engine = PersonalizationEngine(PersonalizeConfig(
        n_classes=C, alpha_grid=(0.0, 1.0, 4.0, 16.0, 64.0)), device=dev)
    heads = engine.solve_heads(state, packed)  # K heads + α selection, ONE call
    alphas = heads.alpha.cpu().numpy()

    reference = ReferencePersonalizedLoop(engine.cfg, device=dev)  # K+1 dispatches
    _, W_ref = reference.solve_at(state, packed, alphas)
    dW = float((heads.W - W_ref).abs().max())

    print(f"{K} tenants ({len(drifted)} with drifted label concepts): "
          f"engine={engine.dispatches} dispatch, per-client loop={reference.dispatches} (K+1)")
    print(f"engine vs per-client re-solves: max|ΔW| = {dW:.2e}\n")

    print("tenant | drift | α_k   | acc(global) | acc(personalized)")
    acc_p, acc_g = [], []
    for k, (x, y) in enumerate(eval_xy):
        x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        y = torch.as_tensor(np.asarray(y), device=dev)
        a_g = float(fed3r.accuracy(W_global, x, y))
        a_p = float(fed3r.accuracy(heads.W[k], x, y))
        acc_g.append(a_g)
        acc_p.append(a_p)
        print(f"{k:6d} | {'  yes' if k in drifted else '   no'} | "
              f"{float(alphas[k]):5.1f} | {a_g:11.4f} | {a_p:.4f}")

    n_global_heads = int(np.sum(alphas == 0.0))
    print(f"\nmean over tenants: global={np.mean(acc_g):.4f}  personalized={np.mean(acc_p):.4f}")
    print(f"{n_global_heads} tenants selected α=0 — their served head IS the global "
          f"factored_solution, bitwise")
    return {"alpha": alphas.tolist(), "acc_global": acc_g, "acc_personalized": acc_p,
            "n_eval": [len(y) for _, y in eval_xy], "engine_vs_loop": dW,
            "dispatches": engine.dispatches, "loop_dispatches": reference.dispatches,
            "drifted": drifted, "alpha0_bitwise": all(
                bool(torch.equal(heads.W[k], W_global)) for k in range(K) if alphas[k] == 0.0)}


if __name__ == "__main__":
    main()
