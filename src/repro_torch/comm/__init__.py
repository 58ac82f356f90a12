from repro_torch.comm.agent import Agent
from repro_torch.comm.methods import (METHODS, CommRequest, MethodResult,
                                      get_method, register)
from repro_torch.comm.remote import (ChannelClosedError, ChannelTimeoutError,
                                     FileChannel, LoopbackChannel,
                                     RemoteChannel, RemoteProtocolError,
                                     RemoteTransport, SocketChannel)
from repro_torch.comm.resilience import (RETRIABLE_ERRORS, CircuitBreaker,
                                         CircuitOpenError, DegradationEvent,
                                         Fault, FaultSchedule, FaultyChannel,
                                         Resilience, RetriesExhaustedError,
                                         RetryPolicy, default_resilience)
from repro_torch.comm.session import CommSession, SenderHandle
from repro_torch.comm.transport import (InMemoryTransport,
                                        SerializedTransport, Transport,
                                        WirePlan)

__all__ = ["METHODS", "RETRIABLE_ERRORS", "Agent", "ChannelClosedError",
           "ChannelTimeoutError", "CircuitBreaker", "CircuitOpenError",
           "CommRequest", "CommSession", "DegradationEvent", "Fault",
           "FaultSchedule", "FaultyChannel", "FileChannel",
           "InMemoryTransport", "LoopbackChannel", "MethodResult",
           "RemoteChannel", "RemoteProtocolError", "RemoteTransport",
           "Resilience", "RetriesExhaustedError", "RetryPolicy",
           "SenderHandle", "SerializedTransport", "SocketChannel",
           "Transport", "WirePlan", "default_resilience", "get_method",
           "register"]
