"""Set-up, the measured window and the traced wave of one cell, on any
device: ``run.py`` drives it on the card, the tests on the CPU at a tiny
size.

The system under test is ``repro_torch``: a sender and a receiver
``Agent``, the cell's transport, a ``CommSession`` whose selection is
frozen by ``CommSession.calibrate`` on one request of the cell's traffic
at ``KVCommConfig(ratio=0.5, alpha=0.7)``, and a ``Scheduler`` with the
cell's capacity on the ``kernel`` decode backend. The window calls
``Scheduler.run`` on consecutive waves of W requests until it has lasted
``seconds``, and counts every wave it started.
"""
from __future__ import annotations

import gc
import importlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from kvbench import check, families, generator, weights
from kvbench.check import Served

HERE = Path(__file__).resolve().parent
RATIO, ALPHA = 0.5, 0.7
PAD, BOS = 0, 1
CALIB_KEY = "bench"


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``BENCHMARK.json``'s workloads with its files."""
    name: str
    entry: Dict
    config: Dict            # kvbench/configs/<config>.json
    mix: Dict               # kvbench/traffic/<traffic>.json
    spec: Dict              # kvbench/workloads/<cell>.json
    family: ModuleType      # kvbench/families/<config's "family">.py
    numbers: tuple          # the names the check compares

    @property
    def model(self) -> Dict:
        return self.config["model"]

    @property
    def mlp(self) -> str:
        return self.config["mlp"]


def make_cell(name: str, entry: Dict, config: Dict, mix: Dict,
              spec: Dict) -> Cell:
    """A cell with its family resolved and a limit in ``spec`` for every
    number the check compares; raises before any weights are made."""
    family = families.of(config)
    names = check.names(family)
    missing = [n for n in names if n not in spec["limits"]]
    if missing:
        raise ValueError(f"{name}: kvbench/workloads/{name}.json has no "
                         f"limit for {missing}")
    return Cell(name=name, entry=entry, config=config, mix=mix, spec=spec,
                family=family, numbers=names)


def load_cell(manifest: Dict, name: str, base: Path = HERE) -> Cell:
    """Find a cell and its configuration, traffic and check files by the
    names ``BENCHMARK.json`` gives."""
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e = entries[name]
    return make_cell(name, e,
                     load_json(base / "configs" / f"{e['config']}.json"),
                     generator.validate(
                         load_json(base / "traffic" / f"{e['traffic']}.json")),
                     load_json(base / "workloads" / f"{name}.json"))


def reader_name(metric: str) -> str:
    """The reader of a metric: the part of its name before the first dot
    (``mfu_pct.doc_qa`` is read as ``mfu_pct`` is)."""
    return metric.split(".", 1)[0]


def metric_module(name: str):
    """The reader of a metric: ``kvbench/metrics/<reader_name>.py``."""
    return importlib.import_module(f"kvbench.metrics.{reader_name(name)}")


@dataclass
class Wave:
    items: List[generator.Item]
    completions: Dict[int, object]
    stats: Dict
    seconds: float = 0.0         # the host's clock around Scheduler.run


@dataclass
class Record:
    """What the readers of the metrics read."""
    cell: Cell
    device_kind: str
    setup_s: float = 0.0
    warmup_s: float = 0.0
    window_s: float = 0.0
    waves: List[Wave] = field(default_factory=list)
    peak_bytes: int = 0
    wire_bytes: int = 0
    prefix_tokens: int = 0
    layers: tuple = ()
    traced: Optional[Wave] = None
    trace: Optional[Dict] = None

    @property
    def items(self) -> List[generator.Item]:
        return [it for w in self.waves for it in w.items]


class Bench:
    """The program set up for one cell and one seed."""

    def __init__(self, cell: Cell, seed: int, device, params=None):
        from repro_torch.comm import (Agent, CommSession, InMemoryTransport,
                                      SerializedTransport)
        from repro_torch.configs.base import ModelConfig
        from repro_torch.core.types import KVCommConfig
        from repro_torch.models import transformer as tfm
        from repro_torch.serving.scheduler import (Request, Scheduler,
                                                   SchedulerConfig)
        self._Request = Request
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.cfg = ModelConfig(**cell.model)
        if tfm.mlp_type(self.cfg) != cell.mlp:
            raise ValueError(f"{cell.config['name']}: the port runs a "
                             f"{tfm.mlp_type(self.cfg)} MLP, the file "
                             f"states {cell.mlp}")
        self.params = params or make_param_sets(cell, seed, self.device)
        tok = SimpleNamespace(PAD=PAD, BOS=BOS)
        mix = cell.mix
        transport = (SerializedTransport(mix["wire_dtype"])
                     if mix["transport"] == "serialized"
                     else InMemoryTransport())
        self.session = CommSession(
            Agent("sender", self.cfg, self.params[0], tok),
            Agent("receiver", self.cfg, self.params[1], tok), transport)
        self.calib = generator.calibration_item(mix, seed,
                                                self.cfg.vocab_size)
        self.scores = self.session.calibrate(
            self.calib.context[None, :], self.calib.query[None, :],
            key=CALIB_KEY).numpy()
        kvcfg = KVCommConfig(ratio=RATIO, alpha=ALPHA)
        self.scheduler = Scheduler(
            self.session, kvcfg, calib_key=CALIB_KEY,
            config=SchedulerConfig(capacity=mix["capacity"],
                                   decode_backend="kernel"))
        self.select = self.session.selection(kvcfg, key=CALIB_KEY).numpy()

    @property
    def layers(self) -> tuple:
        return tuple(self.scheduler.layers)

    @property
    def wire(self) -> Optional[str]:
        mix = self.cell.mix
        return mix["wire_dtype"] if mix["transport"] == "serialized" \
            else None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_wave(self, items: List[generator.Item]) -> Wave:
        reqs = [self._Request(rid=it.rid, context=it.context, query=it.query,
                              max_new=it.answer) for it in items]
        t0 = time.perf_counter()
        comps, stats = self.scheduler.run(reqs)
        self.sync()
        return Wave(items=items, completions={c.rid: c for c in comps},
                    stats=stats, seconds=time.perf_counter() - t0)

    def warmup(self) -> float:
        """One untimed wave at the window's prompt lengths with short
        answers; returns its seconds."""
        return self.run_wave(generator.warmup_wave(
            self.cell.mix, self.seed, self.cfg.vocab_size)).seconds

    def window(self, rec: Record, seconds: float) -> int:
        """Waves until ``seconds`` have passed; returns the next wave
        index."""
        tr = self.session.transport
        bytes0 = tr.total_bytes
        k = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            rec.waves.append(self.run_wave(generator.wave(
                self.cell.mix, self.seed, k, self.cfg.vocab_size)))
            k += 1
        rec.window_s = time.perf_counter() - t0
        rec.wire_bytes = tr.total_bytes - bytes0
        rec.prefix_tokens = sum(len(it.context) + 1 for it in rec.items)
        rec.layers = self.layers
        return k

    def served(self, waves: List[Wave]) -> List[Served]:
        out = []
        for w in waves:
            for it in w.items:
                c = w.completions.get(it.rid)
                out.append(Served(rid=it.rid, context=it.context,
                                  query=it.query, answer=it.answer,
                                  tokens=None if c is None
                                  else np.asarray(c.tokens)))
        return out

    def release(self) -> None:
        """Drop the program's serving state (the slot table, the session's
        caches); the weights stay for the reference."""
        self.scheduler.state = None
        self.scheduler = None
        self.session = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def make_param_sets(cell: Cell, seed: int, device) -> tuple:
    """(sender, receiver) parameters: two sets (seed, seed + 1) or one
    serving both roles, as the configuration file states, in the leaves
    of the configuration's family."""
    spec = cell.family.leaves(cell.model, cell.mlp)
    dt = getattr(torch, cell.model.get("dtype", "bfloat16"))
    n = cell.config["parameter_sets"]
    a = weights.make_params(spec, seed, device, dt)
    b = weights.make_params(spec, seed + 1, device, dt) if n == 2 else a
    return a, b
