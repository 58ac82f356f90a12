"""A tiny cell for the harness's CPU tests: the starcoder2 family cut to
4 layers of width 128 (the port picks its gelu MLP by the name), bf16 on
the CPU, waves of 4. Its limits were read from seeds 100-105 at this size:
the program's widest gap <= 0.026 and score error <= 0.008; the float8
control's >= 0.055 and >= 0.038."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MODEL = dict(name="starcoder2-tiny", arch_type="dense", num_layers=4,
                  d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
                  d_ff=256, vocab_size=512, rope_theta=1e5,
                  tie_embeddings=False, norm_eps=1e-5, dtype="bfloat16")
TINY_LIMITS = {"gap_max": 0.04, "score_err": 0.02, "sel_mismatch": 0,
               "failed": 0}


def tiny_cell(name="starcoder2-7b.doc_qa", transport="serialized",
              family=None, limits=None):
    """``family`` goes into the configuration file's ``"family"`` key,
    ``limits`` beside the tiny ones."""
    from kvbench import generator
    from kvbench.harness import make_cell
    mix = {"context": {"dist": "log_uniform", "min": 24, "max": 60},
           "query": {"dist": "uniform", "min": 4, "max": 9},
           "answer": {"dist": "uniform", "min": 3, "max": 7},
           "wave": 4, "capacity": 4, "transport": transport}
    if transport == "serialized":
        mix["wire_dtype"] = "int8"
    config = {"name": "starcoder2-tiny", "model": TINY_MODEL, "mlp": "gelu",
              "parameter_sets": 2}
    if family is not None:
        config["family"] = family
    return make_cell(name, {"chips": 1}, config, generator.validate(mix),
                     {"sample_tokens": 20,
                      "limits": {**TINY_LIMITS, **(limits or {})}})


@pytest.fixture
def manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)
