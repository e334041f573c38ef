"""Small configurations and traffic for the harness's CPU tests: the
cells' files with the sizes cut (the port's `cpu_scale()` NeRF widths and
`llava-smoke`), everything else as committed."""
from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load(rel: str) -> dict:
    with open(ROOT / rel) as f:
        return json.load(f)


def ngp_config() -> dict:
    cfg = copy.deepcopy(load("bench/configs/ngp-paper-chair.json"))
    cfg["hash"] = {"n_levels": 8, "n_features": 2, "log2_table_size": 11,
                   "base_resolution": 4, "max_resolution": 64}
    cfg.update(hidden_dim=32, color_hidden_dim=32, sh_degree=3)
    return cfg


def ngp_traffic(name: str) -> dict:
    tr = copy.deepcopy(load(f"bench/traffic/{name}.json"))
    tr.update(viewers=3, image_hw=32, trace_steps=4,
              engine={"slots": 2, "slot_rays": 512})
    if tr["poses"]["source"] == "orbits":
        tr["poses"]["elevations"] = tr["poses"]["elevations"][:3]
        tr["poses"]["phases"] = tr["poses"]["phases"][:3]
        tr.update(warmup_frames=4, check={"exact": 2})
    return tr


def lm_config() -> dict:
    cfg = copy.deepcopy(load("bench/configs/llava-next-mistral-7b.json"))
    cfg.update(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               vocab_size=512, image_seq_length=8, torch_dtype="float32")
    return cfg


def lm_traffic() -> dict:
    tr = copy.deepcopy(load("bench/traffic/vqa-offline-b32.json"))
    tr.update(batch=4, text_lengths=[8, 16, 24, 32], gen_tokens=16,
              trace_batches=2, check_requests=8)
    return tr


def lm_control_config() -> dict:
    """A size at which float8 products move the logits about as far as at
    the cell's (8 layers, d 256): the smoke config's do not."""
    cfg = lm_config()
    cfg.update(num_hidden_layers=8, hidden_size=256, intermediate_size=768,
               num_attention_heads=8, num_key_value_heads=2, head_dim=32,
               vocab_size=4096, image_seq_length=16)
    return cfg


def limits(workload: str) -> dict:
    return load(f"bench/checks/{workload}.json")
