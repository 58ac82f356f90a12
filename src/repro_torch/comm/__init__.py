"""repro_torch.comm — the composable communication stack of the port, with
the names of ``repro.comm``: ``Agent``, the transports, the ``CommMethod``
registry, ``CommSession``, the remote wire and the resilience ladder, and
the ``LayerMap`` policies of heterogeneous pairs."""
from repro_torch.comm.agent import Agent
from repro_torch.comm.methods import (METHODS, CommMethod, CommRequest,
                                      MethodResult, get_method, register)
from repro_torch.comm.remote import (DEFAULT_CHUNK_BYTES,
                                     ChannelClosedError,
                                     ChannelTimeoutError, FileChannel,
                                     FrameCorruptError, FrameTruncatedError,
                                     HeaderCorruptError, KVStreamAssembler,
                                     KVStreamSender, LoopbackChannel,
                                     PayloadMismatchError, RemoteChannel,
                                     RemoteProtocolError, RemoteTransport,
                                     SocketChannel, VersionSkewError,
                                     recv_shared, send_shared)
from repro_torch.comm.resilience import (RETRIABLE_ERRORS, CircuitBreaker,
                                         CircuitOpenError, DegradationEvent,
                                         Fault, FaultSchedule, FaultyChannel,
                                         Resilience, RetriesExhaustedError,
                                         RetryPolicy, default_resilience)
from repro_torch.comm.session import CommSession, SenderHandle
from repro_torch.comm.transport import (InMemoryTransport,
                                        SerializedTransport, TransferRecord,
                                        Transport, WirePlan, as_wire_plan,
                                        resolve_wire_dtype, wire_spec)
from repro_torch.core.layermap import (LAYER_MAPS, LayerAssignment,
                                       LayerMap, get_layer_map,
                                       register_layer_map)

__all__ = [
    "Agent", "ChannelClosedError", "ChannelTimeoutError", "CircuitBreaker",
    "CircuitOpenError", "CommMethod", "CommRequest", "CommSession",
    "DEFAULT_CHUNK_BYTES", "DegradationEvent", "Fault", "FaultSchedule",
    "FaultyChannel", "FileChannel", "FrameCorruptError",
    "FrameTruncatedError", "HeaderCorruptError", "InMemoryTransport",
    "KVStreamAssembler", "KVStreamSender", "LAYER_MAPS", "LayerAssignment",
    "LayerMap", "LoopbackChannel", "METHODS", "MethodResult",
    "PayloadMismatchError", "RETRIABLE_ERRORS", "RemoteChannel",
    "RemoteProtocolError", "RemoteTransport", "Resilience",
    "RetriesExhaustedError", "RetryPolicy", "SenderHandle",
    "SerializedTransport", "SocketChannel", "TransferRecord", "Transport",
    "VersionSkewError", "WirePlan", "as_wire_plan", "default_resilience",
    "get_layer_map", "get_method", "recv_shared", "register",
    "register_layer_map", "resolve_wire_dtype", "send_shared", "wire_spec",
]
