from repro_torch.comm.agent import Agent
from repro_torch.comm.session import CommSession
from repro_torch.comm.transport import (InMemoryTransport,
                                        SerializedTransport, Transport)

__all__ = ["Agent", "CommSession", "InMemoryTransport",
           "SerializedTransport", "Transport"]
