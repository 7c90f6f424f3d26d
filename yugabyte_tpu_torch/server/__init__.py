"""Shared server-process infrastructure (ref: src/yb/server —
RpcAndWebServerBase, webserver, path handlers).

Counterpart of yugabyte_tpu/server/__init__.py, with the imports
renamed."""

from yugabyte_tpu_torch.server.webserver import Webserver

__all__ = ["Webserver"]
