"""KVComm core: the paper's contribution as composable PyTorch functions.

The names of ``repro.core``. ``protocol.py`` imports the models, and the
models import ``core.selection``, so the protocol's names load on first
use: importing a model first does not cycle back through this package."""
from repro_torch.core.channel import (Channel, TransferRecord,
                                      combine_senders, kv_wire_bytes,
                                      kv_wire_bytes_paged)
from repro_torch.core.layermap import (LAYER_MAPS, LayerAssignment,
                                       LayerMap, get_layer_map,
                                       register_layer_map)
from repro_torch.core.selection import (gaussian_prior, interp_scores,
                                        kendall_tau, normalize_scores,
                                        select_layers, selection_scores,
                                        topk_mask)
from repro_torch.core.types import KVCommConfig, SharedKV

_PROTOCOL = (
    "build_mapped", "build_packed", "build_shared", "calibrate",
    "decode_step", "extract_kv", "extract_states", "gather_mapped",
    "gather_selected", "generate", "make_selection", "pack_mapped",
    "pack_shared", "pad_prefix", "ragged_decode_step", "receiver_decode",
    "receiver_prefill", "scatter_mapped", "selected_layer_ids",
    "sender_prefill", "transmit",
)


def __getattr__(name):
    if name in _PROTOCOL:
        from repro_torch.core import protocol
        return getattr(protocol, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Channel", "KVCommConfig", "LAYER_MAPS", "LayerAssignment", "LayerMap",
    "SharedKV", "TransferRecord", "build_mapped", "build_packed",
    "build_shared", "calibrate", "combine_senders", "decode_step",
    "extract_kv", "extract_states", "gather_mapped", "gather_selected",
    "gaussian_prior", "generate", "get_layer_map", "interp_scores",
    "kendall_tau", "kv_wire_bytes", "kv_wire_bytes_paged", "make_selection",
    "normalize_scores",
    "pack_mapped", "pack_shared", "pad_prefix", "ragged_decode_step",
    "receiver_decode", "receiver_prefill",
    "register_layer_map", "scatter_mapped", "select_layers",
    "selected_layer_ids", "selection_scores", "sender_prefill", "topk_mask",
    "transmit",
]
