"""Fig. 5-style qualitative comparison on the PyTorch port: render a
held-out view under full precision / PTQ / a HERO-style mixed policy and
report per-image PSNR + save PPM images (no imaging deps needed).

Runs on the card unless given `--device cpu`; `--tiny` shrinks the scene
and the training to a few seconds on the CPU.

  PYTHONPATH=src python examples/torch/render_compare.py --out renders
  PYTHONPATH=src python examples/torch/render_compare.py --device cpu --tiny
"""
import argparse
import dataclasses
from pathlib import Path

import numpy as np

from repro_torch.configs import ngp as ngp_cfg
from repro_torch.core import EnvConfig, NGPQuantEnv
from repro_torch.kernels.backend import resolve_device
from repro_torch.nerf.dataset import make_dataset
from repro_torch.nerf.ngp import spec_from_policy, uniform_quant_spec
from repro_torch.nerf.scenes import SceneConfig
from repro_torch.nerf.train import render_test_view, train_ngp
from repro_torch.quant.policy import QuantPolicy


def save_ppm(path: Path, img: np.ndarray):
    """Tiny PPM writer (P6) — viewable everywhere, zero dependencies."""
    h, w = img.shape[:2]
    data = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(data.tobytes())


def psnr(a, b):
    mse = float(np.mean((a - b) ** 2))
    return -10 * np.log10(max(mse, 1e-12))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="renders")
    ap.add_argument("--scene", default="chair")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="a 12x12 scene, 10 train steps, a 2-step finetune")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    hw = 12 if args.tiny else 32
    ds = make_dataset(SceneConfig(name=args.scene, image_hw=hw,
                                  n_train_views=3 if args.tiny else 8,
                                  n_test_views=2), device=dev)
    cfg = ngp_cfg.cpu_scale()
    rcfg = ngp_cfg.cpu_render()
    tcfg = ngp_cfg.cpu_train()
    ecfg = EnvConfig(finetune_steps=25, trace_rays=256)
    if args.tiny:
        tcfg = dataclasses.replace(tcfg, steps=10)
        ecfg = EnvConfig(finetune_steps=2, trace_rays=32, calib_points=128)
    params, _ = train_ngp(ds, cfg, rcfg, tcfg, device=dev)
    env = NGPQuantEnv(params, ds, cfg, rcfg, tcfg, ecfg, device=dev)

    gt = ds.test_rgb[0].reshape(hw, hw, 3)
    save_ppm(out / "ground_truth.ppm", gt)

    renders = {}
    renders["full_precision"] = render_test_view(params, ds, cfg, rcfg, 0,
                                                 device=dev)

    # PTQ 4-bit (aggressive, shows artifacts like the paper's Fig. 5 PTQ)
    spec4 = uniform_quant_spec(cfg, 4, env.act_ranges, device=dev)
    renders["ptq_4bit"] = render_test_view(params, ds, cfg, rcfg, 0, spec4,
                                           device=dev)

    # HERO-style mixed policy: coarse hash levels high, fine low; sensitive
    # first/last layers high (finetuned like an episode evaluation).
    n_hash = cfg.hash.n_levels
    bits = ([7] * (n_hash // 2) + [4] * (n_hash - n_hash // 2)
            + [6, 6, 7, 7, 5, 5, 5, 5, 6, 6])[: env.n_units]
    bits += [6] * (env.n_units - len(bits))
    res = env.evaluate_bits(bits)
    spec = spec_from_policy(
        cfg, QuantPolicy.uniform(env.units, 8).with_bits(bits), env.act_ranges
    )
    renders["hero_mixed"] = render_test_view(params, ds, cfg, rcfg, 0, spec,
                                             device=dev)

    print(f"{'render':16s} {'PSNR vs GT':>10s}")
    for name, img in renders.items():
        save_ppm(out / f"{name}.ppm", img)
        print(f"{name:16s} {psnr(img, gt):10.2f}  -> {out}/{name}.ppm")
    print(f"\nmixed-policy episode: PSNR {res.psnr:.2f} dB, "
          f"latency {res.latency_cycles:.3e} cycles, FQR {res.fqr:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
