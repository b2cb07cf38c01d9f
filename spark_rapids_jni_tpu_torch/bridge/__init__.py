"""Bridge layer: JVM/native <-> the port's device server.

The port of ``spark_rapids_jni_tpu/bridge``.  Bulk data never crosses the
FFI per op, only 64-bit handles do (the reference's ``RowConversionJni.cpp``
unwraps a jlong to a ``cudf::table_view*``).  A JVM and the device runtime
do not share one address space here, so the handle table lives in a
long-lived device server process:

- ``server``: owns a ``HandleTable`` of the port's tables and columns,
  tensors on the server's device, and speaks a length-prefixed protocol
  over a Unix domain socket;
- ``client``: the pure-Python client on the port's ``Table``, and
  ``spawn_server``;
- ``protocol``, ``shm``: copies of the JAX package's wire constants and
  shared-memory segments, so its ``BridgeClient``, the C ABI
  (``src/main/cpp``) and the Java surface reach this server unchanged.

Host columns cross once, at import and export, through POSIX shared memory
in Arrow layout (data buffer + byte-per-row validity).
"""

from .client import BridgeClient, spawn_server

__all__ = ["BridgeClient", "spawn_server"]
