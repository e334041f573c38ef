"""No module that a run loads is JAX's or the JAX package's; the check
compares whole top-level names, so `repro_torch` passes."""
import subprocess
import sys

from bench import run
from smoke import ROOT

REHEARSAL = """
import sys
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
import torch
from bench import run
from bench.drivers import lm, ngp
from smoke import *
cpu = torch.device("cpu")
ngp.run(ngp_config(), ngp_traffic("orbit-fresh-800"), limits("ngp-fresh-800"),
        5, 0.3, True, cpu)
lm.run(lm_config(), lm_traffic(), limits("llava-vqa-offline"), 5, 0.3, True,
       cpu)
print("FORBIDDEN", run.forbidden_modules())
print("PORT", "repro_torch" in sys.modules)
"""


def test_a_rehearsal_loads_no_jax():
    code = REHEARSAL.format(src=str(ROOT / "src"), root=str(ROOT),
                            tests=str(ROOT / "bench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert "FORBIDDEN []" in lines and "PORT True" in lines


def test_names_compare_whole(monkeypatch):
    fake = {"repro_torch.nerf": object(), "reprox": object(),
            "jaxtyping": object(), "repro.nerf": object(), "flax": object()}
    for k, v in fake.items():
        monkeypatch.setitem(sys.modules, k, v)
    found = run.forbidden_modules()
    assert "repro.nerf" in found and "flax" in found
    assert not {"repro_torch.nerf", "reprox", "jaxtyping"} & set(found)


def test_the_reference_imports_nothing_of_the_port():
    for name in ("ngp.py", "lm.py"):
        text = (ROOT / "bench" / "reference" / name).read_text()
        imports = [l for l in text.splitlines()
                   if l.startswith(("import ", "from "))]
        assert not [l for l in imports
                    if "repro" in l or "jax" in l or "bench" in l], imports
