"""Host-level RPC: the control-plane transport of the port.

Counterpart of yugabyte_tpu/rpc, with the imports renamed. The reference
moves ALL traffic (data + control) through a custom epoll/libev reactor
RPC stack (ref: src/yb/rpc/README:16-79, Messenger messenger.h, Proxy
proxy.h, ServiceIf service_if.h). Here this package carries host-side
control traffic: consensus messages, heartbeats, DDL, tablet reads/writes
between processes. It is deliberately a threaded (not reactor) design —
Python's socket layer is not the hot path. Its wire format (the codec's
bytes and the frame layout) is the JAX package's, byte for byte, so a
port process and a JAX process talk to each other.
"""

from yugabyte_tpu_torch.rpc.codec import dumps, loads
from yugabyte_tpu_torch.rpc.messenger import (
    Messenger, Proxy, RemoteError, RpcTimeout, ServiceUnavailable)

__all__ = ["dumps", "loads", "Messenger", "Proxy", "RemoteError",
           "RpcTimeout", "ServiceUnavailable"]
