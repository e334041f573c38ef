"""End-to-end training demo on the PyTorch port: train an assigned
arch's smoke model for a few hundred steps with checkpoint/restart.

Thin wrapper over `repro_torch.launch.train` — kill it mid-run and run it
again to see the fault-tolerance path (atomic checkpoint + exact data
resume: it resumes from the newest checkpoint in `--ckpt-dir`).

Runs on the card unless given `--device cpu`.

  PYTHONPATH=src python examples/torch/distributed_train.py
  PYTHONPATH=src python examples/torch/distributed_train.py --device cpu
"""
import argparse

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default="experiments/torch_train_ckpt")
    args = ap.parse_args(argv)
    argv = ["--arch", "llama3-405b", "--smoke",
            "--steps", str(args.steps), "--seq-len", "128",
            "--global-batch", "8", "--accum", "2",
            "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50", "--resume"]
    if args.device:
        argv += ["--device", args.device]
    return train_main(argv)


if __name__ == "__main__":
    main()
