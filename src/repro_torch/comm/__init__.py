from repro_torch.comm.agent import Agent
from repro_torch.comm.methods import (METHODS, CommRequest, MethodResult,
                                      get_method, register)
from repro_torch.comm.remote import (FileChannel, LoopbackChannel,
                                     RemoteProtocolError, RemoteTransport,
                                     SocketChannel)
from repro_torch.comm.session import CommSession, SenderHandle
from repro_torch.comm.transport import (InMemoryTransport,
                                        SerializedTransport, Transport,
                                        WirePlan)

__all__ = ["METHODS", "Agent", "CommRequest", "CommSession", "FileChannel",
           "InMemoryTransport", "LoopbackChannel", "MethodResult",
           "RemoteProtocolError", "RemoteTransport", "SenderHandle",
           "SerializedTransport", "SocketChannel", "Transport", "WirePlan",
           "get_method", "register"]
