"""Serve a small model with batched requests on the PyTorch port:
prefill + greedy decode, through the port's serve launcher.

    python examples/serve_lm_torch.py [--arch smollm_135m] [--device cpu]

Without ``--device`` it runs on the card (the flash kernel on the
prefill).
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    a = ap.parse_args()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    # delegate to the serve launcher with a reduced config
    sys.exit(subprocess.call([
        sys.executable, "-m", "repro_torch.launch.serve", "--workload", "lm",
        "--arch", a.arch, "--reduced", "--batch", str(a.batch),
        "--prompt-len", "32", "--gen", "16",
        *(["--device", a.device] if a.device else [])], env=env))
