"""The port's copies of the config and data modules give what the
reference's give: the same config fields, the same tokenizers, and the
same batches for the same seed."""
import dataclasses

import numpy as np
import pytest

from _torch_bridge import as_reference, port_cfg
from repro.configs.registry import get_config as jget_config
from repro.data.synthetic import SyntheticTask as JTask
from repro.data.synthetic import TaskConfig as JTaskConfig
from repro.data.tokenizer import ByteTokenizer as JByte
from repro.data.tokenizer import SymbolTokenizer as JSymbol
from repro.launch import pairs as jpairs
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.data.synthetic import SyntheticTask, TaskConfig
from repro_torch.data.tokenizer import ByteTokenizer, SymbolTokenizer
from repro_torch.launch import pairs


def test_configs_round_trip():
    ref = jget_config("llama3.2-3b-pair")
    assert as_reference(get_config("llama3.2-3b-pair"), ref) \
        == dataclasses.asdict(ref)
    assert port_cfg(ref) == get_config("llama3.2-3b-pair")
    assert list_archs() == ["gemma3-4b", "internlm2-20b",
                            "llama3.2-3b-pair", "mellum2-12b",
                            "mixtral-8x22b",
                            "olmoe-1b-7b", "pixtral-12b", "qwen1.5-110b",
                            "rwkv6-1.6b", "starcoder2-7b", "whisper-medium",
                            "zamba2-2.7b"]
    assert as_reference(pairs.pair_config(), jpairs.pair_config()) \
        == dataclasses.asdict(jpairs.pair_config())
    full = pairs.full_width_config()
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.resolved_head_dim, full.d_ff,
            full.vocab_size, full.dtype, full.tie_embeddings) == \
        (28, 3072, 24, 8, 128, 8192, 128256, "bfloat16", True)
    assert as_reference(get_config("whisper-medium"),
                        jget_config("whisper-medium")) == \
        dataclasses.asdict(jget_config("whisper-medium"))
    with pytest.raises(KeyError):
        get_config("mixtral-8x7b")


def test_tokenizers_match():
    assert SymbolTokenizer(32, 16) == pairs.pair_tokenizer()
    for a, b in ((SymbolTokenizer(16, 8), JSymbol(16, 8)),
                 (pairs.pair_tokenizer(), jpairs.pair_tokenizer())):
        assert (a.vocab_size, a.entity_base, a.attr_base) == \
            (b.vocab_size, b.entity_base, b.attr_base)
    text = "Uma is at the Mahaffie House."
    assert ByteTokenizer().encode(text, bos=True, eos=True) == \
        JByte().encode(text, bos=True, eos=True)


@pytest.mark.parametrize("kind", ["retrieval", "multihop", "decision"])
@pytest.mark.parametrize("seed", [0, 42])
def test_synthetic_batches_match(kind, seed):
    kw = dict(kind=kind, num_facts=6, seed=seed)
    tok, jtok = SymbolTokenizer(16, 8), JSymbol(16, 8)
    ours, ref = SyntheticTask(tok, TaskConfig(**kw)), \
        JTask(jtok, JTaskConfig(**kw))
    for fn in ("batch", "lm_batch"):
        a, b = getattr(ours, fn)(5), getattr(ref, fn)(5)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
