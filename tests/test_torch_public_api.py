"""The port's public names against the JAX package's.

Every public name of each ``src/repro/**/__init__.py`` (read with ``ast``)
resolves in its ``repro_torch`` counterpart, and every ``from repro...
import ...`` of README.md's python blocks and of ``examples/*.py`` resolves
with ``repro`` renamed to ``repro_torch``, but for the one listed
exception. ``import repro_torch.core`` and ``import repro_torch.comm`` work
first thing in a fresh interpreter and load no jax.

Parity, on the same seeded numpy inputs: ``kendall_tau`` equal to the
reference's (float32 sums of signs over one count, so exact; NaN at
L = 1); ``Channel``'s records (bytes, layers, context length) and
``transmit``'s ``SharedKV`` and bytes equal to the reference's on the
bridged float32 tiny model (the K/V within 2e-5: another summation
order)."""
import ast
import dataclasses
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import port_cfg, port_params, t
from repro import core as jcore
from repro.core.types import KVCommConfig as JKVCommConfig
from repro_torch import core
from repro_torch.core.types import KVCommConfig

ROOT = Path(__file__).resolve().parents[1]
KV_TOL = dict(atol=2e-5, rtol=2e-5)

# reference modules with no module of their own in the port, and why
EXCEPTIONS = {
    "repro.kernels.ref": (
        "the oracles live beside each kernel in the port",
        {"repro_torch.kernels.flash_attention": "flash_attention_reference",
         "repro_torch.kernels.flash_decode": "flash_decode_reference",
         "repro_torch.kernels.ragged_decode": "ragged_decode_reference",
         "repro_torch.kernels.rwkv_scan": "wkv6_reference"}),
}


def _public_names(path: Path):
    """The names an ``__init__.py`` exports: its ``__all__``, else the
    names it imports."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(tg, ast.Name) and tg.id == "__all__"
                for tg in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    return [a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names]


def _reference_imports(source: str):
    """(module, [names]) of every ``from repro... import`` in a source."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and node.module.split(".")[0] == "repro":
            yield node.module, [a.name for a in node.names]


def _resolves(module: str, name: str) -> bool:
    mod = importlib.import_module(module)
    if hasattr(mod, name):
        return True
    try:
        importlib.import_module(f"{module}.{name}")
    except ImportError:
        return False
    return True


INITS = sorted((ROOT / "src" / "repro").rglob("__init__.py"))
SOURCES = sorted(str(p.relative_to(ROOT)) for p in
                 (ROOT / "examples").glob("*.py")) + ["README.md"]


@pytest.mark.parametrize("path", INITS,
                         ids=lambda p: str(p.relative_to(ROOT / "src")))
def test_every_public_name_resolves_in_the_port(path):
    module = ".".join(path.parent.relative_to(ROOT / "src").parts)
    port = "repro_torch" + module[len("repro"):]
    missing = [n for n in _public_names(path) if not _resolves(port, n)]
    assert not missing, f"{port} lacks {missing}"
    if path.parent.name in ("core", "comm"):
        assert sorted(importlib.import_module(port).__all__) \
            == sorted(_public_names(path))


@pytest.mark.parametrize("source", SOURCES)
def test_reference_imports_resolve_under_repro_torch(source):
    text = (ROOT / source).read_text()
    blocks = (re.findall(r"```python\n(.*?)```", text, re.S)
              if source.endswith(".md") else [text])
    missing = []
    for block in blocks:
        for module, names in _reference_imports(block):
            for name in names:
                if f"{module}.{name}" in EXCEPTIONS:
                    continue
                port = "repro_torch" + module[len("repro"):]
                if not _resolves(port, name):
                    missing.append(f"{port}.{name}")
    assert not missing, f"{source}: {missing}"


def test_the_listed_exception_has_its_oracles_in_the_port():
    for ref, (_, oracles) in EXCEPTIONS.items():
        parent, name = ref.rsplit(".", 1)
        assert not _resolves("repro_torch" + parent[len("repro"):], name)
        for module, oracle in oracles.items():
            assert callable(getattr(importlib.import_module(module), oracle))


FIRST_IMPORTS = ("repro_torch.core", "repro_torch.comm",
                 "repro_torch.models.layers")


@pytest.fixture(scope="module")
def fresh_imports():
    """Each module imported first in its own interpreter, all at once;
    then the new names, and no jax or reference module loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for module in FIRST_IMPORTS:
        code = (f"import {module}\n"
                "from repro_torch.core import Channel, kendall_tau, "
                "transmit\n"
                "from repro_torch.comm import LayerMap, register_layer_map\n"
                "import sys\n"
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'repro')]\n"
                "assert not bad, bad\n")
        procs[module] = subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    for module, proc in procs.items():
        _, err = proc.communicate(timeout=120)
        out[module] = (proc.returncode, err)
    return out


@pytest.mark.parametrize("module", FIRST_IMPORTS)
def test_import_first_in_a_fresh_interpreter(fresh_imports, module):
    rc, err = fresh_imports[module]
    assert rc == 0, err


@pytest.mark.parametrize("L", [1, 2, 28, 48])
@pytest.mark.parametrize("ties", [False, True])
def test_kendall_tau_matches_reference(L, ties):
    rng = np.random.default_rng(L + 100 * ties)
    if ties:
        a = rng.integers(0, 4, L).astype(np.float32)
        b = rng.integers(0, 4, L).astype(np.float32)
        b[: L // 2] = a[: L // 2]
    else:
        a, b = rng.normal(size=(2, L)).astype(np.float32)
    for x, y in ((a, b), (a, a), (a, -a), (a.astype(np.int32),
                                           b.astype(np.int32))):
        want = np.asarray(jcore.kendall_tau(jnp.asarray(x), jnp.asarray(y)))
        got = core.kendall_tau(t(x), t(y))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    if L == 1:
        assert np.isnan(core.kendall_tau(t(a), t(b)).item())


@pytest.fixture(scope="module")
def bridged(tiny_cfg, tiny_params):
    return port_cfg(tiny_cfg), port_params(tiny_params)


def _exports(tiny_cfg, tiny_params, bridged, B, Sc, seed):
    ctx = np.random.default_rng(seed).integers(
        4, tiny_cfg.vocab_size, (B, Sc)).astype(np.int32)
    jkv, _ = jcore.sender_prefill(tiny_params, tiny_cfg, jnp.asarray(ctx))
    kv, _ = core.sender_prefill(bridged[1], bridged[0], t(ctx).long())
    return jkv, kv


def test_channel_records_match_reference(tiny_cfg, tiny_params, bridged):
    """As the reference's TestChannel: bytes at the analytic count and the
    prefix length, then record for record against its Channel."""
    cfg = bridged[0]
    B, Sc = 3, 10
    jkv, kv = _exports(tiny_cfg, tiny_params, bridged, B, Sc, 1)
    kw = dict(ratio=0.5, selector="prior_only")
    jselect = jcore.make_selection(tiny_cfg, JKVCommConfig(**kw))
    select = core.make_selection(cfg, KVCommConfig(**kw))
    np.testing.assert_array_equal(select.numpy(), np.asarray(jselect))
    jch, ch = jcore.Channel(), core.Channel()
    jshared = jch.send_kv(tiny_cfg, JKVCommConfig(**kw), jkv, jselect)
    shared = ch.send_kv(cfg, KVCommConfig(**kw), kv, select)
    M = int(select.sum())
    assert ch.total_bytes == core.kv_wire_bytes(
        cfg, B, Sc, M, itemsize=kv["k"].element_size()) == jch.total_bytes
    assert shared.prefix_len == jshared.prefix_len == Sc
    for n, per in ((7, 2), (5, 4)):
        assert ch.send_text(n, per) == jch.send_text(n, per) == n * per
    assert ch.total_bytes == jch.total_bytes
    assert [dataclasses.asdict(r) for r in ch.log] \
        == [dataclasses.asdict(r) for r in jch.log]


@pytest.mark.parametrize("with_states", [False, True])
def test_transmit_matches_reference(tiny_cfg, tiny_params, bridged,
                                    with_states):
    cfg = bridged[0]
    jkv, kv = _exports(tiny_cfg, tiny_params, bridged, 2, 7, 2)
    select = np.array([True, False, True, True])
    states = state_select = jstates = jstate_select = None
    if with_states:
        rng = np.random.default_rng(3)
        arrays = {"wkv": rng.normal(size=(3, 2, 4, 8, 8)),
                  "tm_x": rng.normal(size=(3, 2, 32))}
        arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
        mask = np.array([True, False, True])
        jstates = {k: jnp.asarray(v) for k, v in arrays.items()}
        states = {k: t(v) for k, v in arrays.items()}
        jstate_select, state_select = jnp.asarray(mask), t(mask)
    kvcfg = dict(ratio=0.75, pos_mode="zero_unselected")
    jshared, jn = jcore.transmit(tiny_cfg, JKVCommConfig(**kvcfg), jkv,
                                 jnp.asarray(select), jstates, jstate_select)
    shared, n = core.transmit(cfg, KVCommConfig(**kvcfg), kv, t(select),
                              states, state_select)
    assert n == jn
    assert (shared.prefix_len, shared.pos_mode, shared.is_packed) \
        == (jshared.prefix_len, jshared.pos_mode, False)
    np.testing.assert_array_equal(shared.select.numpy(),
                                  np.asarray(jshared.select))
    for p in ("k", "v"):
        np.testing.assert_allclose(shared.kv[p].numpy(),
                                   np.asarray(jshared.kv[p]), **KV_TOL)
    if with_states:
        np.testing.assert_array_equal(shared.state_select.numpy(),
                                      np.asarray(jshared.state_select))
        for k, v in jshared.states.items():
            np.testing.assert_array_equal(shared.states[k].numpy(),
                                          np.asarray(v))
    else:
        assert shared.states is None and jshared.states is None
