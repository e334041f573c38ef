"""HERO's technique applied to an LM architecture on the PyTorch port:
embedding-band bits (the hash-level analogue) + per-layer W/A bits,
searched by the full closed loop against the registered `roofline-lm`
decode cost model — the same CEM + DDPG population search, Pareto
frontier, and checkpointing the NeRF scenes run through.

A thin wrapper over `repro_torch.workloads.lm.LMWorkload`; the cost model
lives in `repro_torch.hero.targets` (`roofline-lm`, the H100's HBM
stream), not here. Equivalent CLI:

  hero-search-torch --workload lm --arch qwen2-7b --quick

Runs the arch's SMOKE config (real loss deltas from real forward passes,
hardware feedback from the analytic roofline) on the card unless given
`--device cpu`.

  PYTHONPATH=src python examples/torch/lm_quant_search.py --iterations 2
  PYTHONPATH=src python examples/torch/lm_quant_search.py --device cpu
"""
import argparse
import time

from repro_torch.core.closed_loop import ClosedLoopConfig, HeroSearchRun
from repro_torch.workloads.lm import LMEnvConfig, LMWorkload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--iterations", type=int, default=2,
                    help="search iterations per budget cell")
    ap.add_argument("--population", type=int, default=8)
    ap.add_argument("--budgets", default="1.0,0.85",
                    help="comma-separated latency-budget fractions")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    budgets = tuple(float(b) for b in args.budgets.split(","))
    cfg = ClosedLoopConfig(
        scenes=(args.arch,),
        budget_fracs=budgets,
        n_iterations=args.iterations,
        population=args.population,
        workload="lm",
        hardware="roofline-lm",
        checkpoint_path=None,
        verbose=True,
    )
    run = HeroSearchRun(cfg, workload=LMWorkload(LMEnvConfig()),
                        device=args.device)

    t0 = time.time()
    result = run.run()

    print(f"\njoint frontier: {len(result.frontier)} point(s), "
          f"hypervolume {result.hypervolume():.4f}")
    for p in result.frontier.points:
        print(f"  {p.scene}: lat ratio {p.latency:.3f}, "
              f"quality delta {p.psnr:+.2f} dB, size ratio "
              f"{p.model_bytes:.3f}, FQR {sum(p.bits)/len(p.bits):.2f}")
    best = max(result.cells, key=lambda c: c.best_reward)
    print(f"best cell {best.scene}@{best.budget_frac}: "
          f"reward {best.best_reward:+.3f}, bits {list(best.best_bits)}")
    print(f"total {time.time()-t0:.0f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
