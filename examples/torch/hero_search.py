"""One-command closed-loop HERO search on the PyTorch port: scenes x
hardware budgets in, a Pareto frontier (latency / PSNR / model size) out.

Thin wrapper over the `hero-search-torch` console entry point
(`repro_torch.hero.cli.search_main`) so the example keeps working with a
bare checkout. The search trains a small NGP per scene, builds the
quantization env against the chosen hardware target (`--hardware`,
default the cycle-accurate NeuRex simulator), runs the population search
per (scene, budget) cell and merges every evaluated policy into
per-scene and joint Pareto frontiers. Writes BENCH_search_torch.json and
checkpoints after each cell, so an interrupted run resumes where it
stopped. Runs on the card unless given `--device cpu`.

  PYTHONPATH=src python examples/torch/hero_search.py --quick
  PYTHONPATH=src python examples/torch/hero_search.py \\
      --scenes chair,lego,ficus --budgets 1.0,0.85,0.7 --iterations 8
  PYTHONPATH=src python examples/torch/hero_search.py --quick --device cpu \\
      --workload lm --arch qwen2-7b
"""
from __future__ import annotations

from repro_torch.hero.cli import search_main as main

if __name__ == "__main__":
    raise SystemExit(main())
