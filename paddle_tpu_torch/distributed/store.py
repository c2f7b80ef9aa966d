"""Key-value rendezvous stores (port of the JAX package's
``distributed/store.py``).

The reference rendezvouses ranks through a ``TCPStore``
(paddle/phi/core/distributed/store/tcp_store.h:121 — set/get/add/wait/
barrier over a socket server on rank 0). ``FileStore`` is the
no-network store for processes of one host (the fleet's replica
registry, the worker heartbeats); ``TCPStore`` is a socket server and
its clients.

The JAX package's ``Store`` wraps jax's coordination service; its torch
counterpart here wraps the store of the default process group, so it
works once :func:`~paddle_tpu_torch.distributed.env.init_parallel_env`
(or the caller's own ``init_process_group``) has joined a world, and
raises naming ``init_parallel_env`` before. :func:`current_store` takes
it, else the ``PADDLE_STORE_DIR`` FileStore. ``FileStore.barrier``
without ``world_size`` takes the world's size, likewise.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

__all__ = ["Store", "FileStore", "TCPStore", "current_store"]


class Store:
    """TCPStore-shaped API over the default process group's store (the
    JAX package's ``Store`` over jax's coordination service). Keys live
    under ``prefix``; :meth:`list` reads an index of the keys set through
    this API, kept in the store with an atomic counter."""

    def __init__(self, prefix: str = "paddle_store"):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "Store requires an initialized distributed runtime (call "
                "paddle_tpu_torch.distributed.init_parallel_env first)")
        self._c = dist.distributed_c10d._get_default_store()
        self._prefix = prefix

    def _k(self, key: str) -> str:
        return f"{self._prefix}/{key}"

    def _wait(self, keys, timeout: float):
        # polled, not c10d's blocking wait: a client serialises its
        # calls, and a long wait on one thread (a checkpoint writer's
        # barrier) would hold the watchdog's abort poll on another
        full = [self._k(k) for k in keys]
        deadline = time.monotonic() + timeout
        while not self._c.check(full):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"store keys {list(keys)!r} not set within {timeout}s")
            time.sleep(0.01)

    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        if not self._c.check([self._k(key)]):
            n = self._c.add(self._k("__index__/n"), 1)
            self._c.set(self._k(f"__index__/{n}"), key)
        self._c.set(self._k(key), value)

    def get(self, key: str, timeout: float = 300.0) -> bytes:
        self._wait([key], timeout)
        return bytes(self._c.get(self._k(key)))

    def try_get(self, key: str) -> Optional[bytes]:
        if not self._c.check([self._k(key)]):
            return None
        return bytes(self._c.get(self._k(key)))

    def delete(self, key: str) -> None:
        self._c.delete_key(self._k(key))

    def list(self, prefix: str = "") -> List[str]:
        n = self._c.add(self._k("__index__/n"), 0)
        keys = []
        for i in range(1, n + 1):
            k = self.try_get(f"__index__/{i}")
            if k is None:
                continue
            k = k.decode()
            if k.startswith(prefix) and k not in keys and \
                    self._c.check([self._k(k)]):
                keys.append(k)
        return keys

    def add(self, key: str, amount: int = 1) -> int:
        """Atomic counter (TCPStore::add)."""
        return int(self._c.add(self._k(key), int(amount)))

    def wait(self, keys, timeout: float = 300.0) -> None:
        if isinstance(keys, str):
            keys = [keys]
        self._wait(keys, timeout)

    def barrier(self, name: str = "barrier", timeout: float = 300.0,
                process_ids=None) -> None:
        """Wait until every rank of the world (or the ``process_ids``
        given) has reached this barrier."""
        import torch.distributed as dist

        n = dist.get_world_size() if process_ids is None \
            else len(process_ids)
        if self.add(f"{name}/enter", 1) == n:
            self.set(f"{name}/done", b"1")
        self.get(f"{name}/done", timeout=timeout)


class FileStore:
    """Filesystem-backed store for same-host process groups (launcher
    tests, elastic heartbeats). Atomicity via O_EXCL create + rename."""

    def __init__(self, path: str):
        self._dir = path
        os.makedirs(path, exist_ok=True)

    def _p(self, key: str) -> str:
        return os.path.join(self._dir, key.replace("/", "__"))

    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        tmp = self._p(key) + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(value)
        os.replace(tmp, self._p(key))

    def get(self, key: str, timeout: float = 300.0) -> bytes:
        deadline = time.time() + timeout
        while time.time() < deadline:
            v = self.try_get(key)
            if v is not None:
                return v
            time.sleep(0.02)
        raise TimeoutError(f"store key {key!r} not set within {timeout}s")

    def try_get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._p(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def delete(self, key: str) -> None:
        try:
            os.remove(self._p(key))
        except FileNotFoundError:
            pass

    def list(self, prefix: str = "") -> List[str]:
        import re

        pat = prefix.replace("/", "__")
        # in-flight writes use ".tmp<pid>" SUFFIX names (see set); they
        # must never surface as phantom keys to pollers — but a user key
        # merely containing ".tmp" (e.g. "config.tmpl") is legitimate
        return [f for f in os.listdir(self._dir)
                if f.startswith(pat)
                and not re.search(r"\.tmp\d+$", f)]

    def add(self, key: str, amount: int = 1) -> int:
        # lock-free: one slot file per add, value = sum of slots
        import uuid

        self.set(f"{key}/slot-{uuid.uuid4().hex}", str(amount))
        total = 0
        for f in self.list(f"{key}/slot-"):
            with open(os.path.join(self._dir, f), "rb") as fh:
                total += int(fh.read())
        return total

    def wait(self, keys, timeout: float = 300.0) -> None:
        if isinstance(keys, str):
            keys = [keys]
        for k in keys:
            self.get(k, timeout=timeout)

    def barrier(self, name: str = "barrier", timeout: float = 300.0,
                world_size: Optional[int] = None, rank: int = 0) -> None:
        if world_size is None:
            import torch.distributed as dist

            if not (dist.is_available() and dist.is_initialized()):
                raise ValueError(
                    "FileStore.barrier needs world_size, or the world's "
                    "size after paddle_tpu_torch.distributed."
                    "init_parallel_env")
            world_size = dist.get_world_size()
        n = self.add(f"{name}/enter", 1)
        deadline = time.time() + timeout
        while n < world_size:
            if time.time() > deadline:
                raise TimeoutError(f"barrier {name!r}: {n}/{world_size}")
            time.sleep(0.02)
            total = 0
            for f in self.list(f"{name}/enter/slot-"):
                with open(os.path.join(self._dir, f), "rb") as fh:
                    total += int(fh.read())
            n = total


_store: Optional[object] = None


def current_store():
    """Process-wide default store: the distributed runtime's Store once a
    world is initialized, else a FileStore under PADDLE_STORE_DIR."""
    global _store
    if _store is None:
        try:
            _store = Store()
        except Exception:
            d = os.environ.get("PADDLE_STORE_DIR")
            if d is None:
                raise
            _store = FileStore(d)
    return _store


class TCPStore:
    """Real TCP key-value store (reference:
    paddle/phi/core/distributed/store/tcp_store.h:121 — a socket server
    on one process, set/get/add/wait clients on every other). It needs no
    distributed runtime and survives gang restarts, so it is the
    registry when processes share no filesystem (the reference uses etcd
    there).

    ``TCPStore.serve(host, port)`` starts the server (the management-job
    role, e.g. inside the launcher); ``TCPStore("host:port")`` is a
    client. Protocol: one JSON line per request over a fresh connection
    — heartbeat-rate traffic, robustness over throughput.
    """

    def __init__(self, addr: str):
        if addr.startswith("tcp://"):
            addr = addr[len("tcp://"):]
        host, port = addr.rsplit(":", 1)
        self._addr = (host, int(port))

    # -- client ----------------------------------------------------------
    def _rpc(self, req: dict):
        import json
        import socket

        with socket.create_connection(self._addr, timeout=10) as s:
            s.sendall(json.dumps(req).encode() + b"\n")
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
        return json.loads(buf.decode())

    def set(self, key: str, value) -> None:
        import base64

        if isinstance(value, str):
            value = value.encode()
        self._rpc({"op": "set", "k": key,
                   "v": base64.b64encode(value).decode()})

    def try_get(self, key: str) -> Optional[bytes]:
        import base64

        r = self._rpc({"op": "get", "k": key})
        return None if r.get("v") is None else base64.b64decode(r["v"])

    def get(self, key: str, timeout: float = 300.0) -> bytes:
        deadline = time.time() + timeout
        while time.time() < deadline:
            v = self.try_get(key)
            if v is not None:
                return v
            time.sleep(0.05)
        raise TimeoutError(f"store key {key!r} not set within {timeout}s")

    def delete(self, key: str) -> None:
        self._rpc({"op": "del", "k": key})

    def list(self, prefix: str = "") -> List[str]:
        # FileStore parity: '/' in stored keys is flattened to '__' in
        # listings (elastic parses names with split("__"))
        return [k.replace("/", "__")
                for k in self._rpc({"op": "list", "p": prefix})["keys"]]

    def add(self, key: str, amount: int = 1) -> int:
        return int(self._rpc({"op": "add", "k": key,
                              "n": int(amount)})["v"])

    def wait(self, keys, timeout: float = 300.0) -> None:
        if isinstance(keys, str):
            keys = [keys]
        for k in keys:
            self.get(k, timeout=timeout)

    # -- server ----------------------------------------------------------
    @staticmethod
    def serve(host: str = "127.0.0.1", port: int = 0):
        """Start the store server on a daemon thread; returns
        (tcp_spec, shutdown_fn)."""
        import base64
        import json
        import socket
        import socketserver
        import threading

        data = {}
        lock = threading.Lock()

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    req = json.loads(self.rfile.readline().decode())
                except Exception:
                    return
                op = req.get("op")
                with lock:
                    if op == "set":
                        data[req["k"]] = base64.b64decode(req["v"])
                        resp = {"ok": 1}
                    elif op == "get":
                        v = data.get(req["k"])
                        resp = {"v": None if v is None
                                else base64.b64encode(v).decode()}
                    elif op == "del":
                        data.pop(req["k"], None)
                        resp = {"ok": 1}
                    elif op == "list":
                        p = req.get("p", "")
                        resp = {"keys": [k for k in data if
                                         k.startswith(p)]}
                    elif op == "add":
                        cur = int(data.get(req["k"], b"0")) + req["n"]
                        data[req["k"]] = str(cur).encode()
                        resp = {"v": cur}
                    else:
                        resp = {"err": f"bad op {op!r}"}
                self.wfile.write(json.dumps(resp).encode() + b"\n")

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        srv = Server((host, port), Handler)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        spec = f"tcp://{host}:{srv.server_address[1]}"
        return spec, srv.shutdown
