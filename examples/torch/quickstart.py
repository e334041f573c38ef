"""Quickstart on the PyTorch port: the HERO pipeline end to end.

1. Render a procedural scene (Synthetic-NeRF stand-in).
2. Train a small Instant-NGP on it.
3. Build the quantization environment (cycle-accurate NeuRex simulator +
   calibrated quantizers).
4. Run a short DDPG search (Eq. 3 actions, Eq. 8 reward) and compare the
   discovered mixed-precision policy against uniform PTQ.

Runs on the card unless given `--device cpu`; `--tiny` shrinks every
stage to a few seconds on the CPU.

  PYTHONPATH=src python examples/torch/quickstart.py
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu --tiny
"""
import argparse
import dataclasses
import time

from repro_torch.configs import ngp as ngp_cfg
from repro_torch.core import EnvConfig, NGPQuantEnv, SearchConfig, hero_search
from repro_torch.core.baselines import ptq_baseline
from repro_torch.core.ddpg import DDPGConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.nerf.dataset import make_dataset
from repro_torch.nerf.scenes import SceneConfig
from repro_torch.nerf.train import evaluate_psnr, train_ngp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="a 12x12 scene, 10 train steps, 2 episodes")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    scene = SceneConfig(name="chair", image_hw=24, n_train_views=6,
                        n_test_views=2)
    tcfg = ngp_cfg.cpu_train()
    ecfg = EnvConfig(finetune_steps=20, trace_rays=256, calib_points=1024)
    n_episodes = 8
    dcfg = DDPGConfig(warmup_episodes=3, updates_per_episode=12)
    if args.tiny:
        scene = dataclasses.replace(scene, image_hw=12, n_train_views=3)
        tcfg = dataclasses.replace(tcfg, steps=10)
        ecfg = EnvConfig(finetune_steps=2, trace_rays=32, calib_points=128)
        n_episodes = 2
        dcfg = DDPGConfig(warmup_episodes=1, updates_per_episode=2)

    t0 = time.time()
    print(f"[1/4] rendering ground-truth scene (procedural 'chair') on "
          f"{dev}...")
    ds = make_dataset(scene, device=dev)

    print("[2/4] training Instant-NGP (CPU scale)...")
    cfg = ngp_cfg.cpu_scale()
    rcfg = ngp_cfg.cpu_render()
    params, loss = train_ngp(ds, cfg, rcfg, tcfg, device=dev)
    psnr = evaluate_psnr(params, ds, cfg, rcfg, device=dev)
    print(f"      full-precision PSNR {psnr:.2f} dB "
          f"({time.time()-t0:.0f}s)")

    print("[3/4] building the quantization env (simulator + calibration)...")
    env = NGPQuantEnv(params, ds, cfg, rcfg, tcfg, ecfg, device=dev)
    n_mlp = (env.n_units - cfg.hash.n_levels) // 2
    print(f"      {env.n_units} quantizable units "
          f"({cfg.hash.n_levels} hash levels + 2x{n_mlp} MLP W/A); "
          f"8-bit baseline latency {env.original_cost:.3e} cycles")

    ptq = ptq_baseline(env, 6)
    print(f"      uniform PTQ(6b): PSNR {ptq.psnr:.2f}, "
          f"latency {ptq.latency_cycles:.3e}, FQR {ptq.fqr:.2f}")

    print(f"[4/4] HERO search ({n_episodes} episodes)...")
    res = hero_search(env, SearchConfig(n_episodes=n_episodes, verbose=True),
                      dcfg, device=dev)
    b = res.best
    print(f"\nHERO best policy: PSNR {b.psnr:.2f} dB, "
          f"latency {b.latency_cycles:.3e} cycles, FQR {b.fqr:.2f}")
    print(f"  hash-level bits: {b.policy.hash_level_bits()}")
    print(f"  weight bits:     {b.policy.weight_bits()}")
    print(f"  activation bits: {b.policy.activation_bits()}")
    print(f"  vs PTQ(6b): {ptq.latency_cycles / b.latency_cycles:.2f}x "
          f"latency, {ptq.fqr / b.fqr:.2f}x model size")
    print(f"total {time.time()-t0:.0f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
