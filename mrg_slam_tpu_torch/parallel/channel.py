"""Transport for inter-robot messages: in-process or TCP sockets.

Counterpart of the JAX package's parallel/channel.py (plain Python, the
port's own copy). The reference's inter-robot path is ROS2 DDS pub/sub
and services (package.xml:13-33). Here the same delta-graph protocol
rides a pluggable channel, so robots can live in one process (tests,
replay), in separate processes or on separate hosts. Payloads are
pickled; what crosses a socket is host data (numpy, and the wire form of
parallel/messages.quantize_graph_msg), never a device tensor, which would
unpickle onto the peer's device.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Callable, Dict, Optional

_LEN = struct.Struct("!Q")


def _send_msg(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket):
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, n))


class InProcessBus:
    """Topic bus + service registry for robots sharing one process."""

    def __init__(self):
        self._subs: Dict[str, list] = {}
        self._services: Dict[str, Callable] = {}
        self._lock = threading.Lock()
        self._executor = None

    def subscribe(self, topic: str, fn: Callable) -> None:
        with self._lock:
            self._subs.setdefault(topic, []).append(fn)

    def publish(self, topic: str, msg) -> None:
        with self._lock:
            subs = list(self._subs.get(topic, []))
        for fn in subs:
            fn(msg)

    def advertise(self, name: str, fn: Callable) -> None:
        with self._lock:
            self._services[name] = fn

    def call(self, name: str, req, timeout: Optional[float] = 20.0):
        """Call a service with the same timeout semantics as SocketClient:
        None on timeout (the reference's async service call + 20 s wait,
        mrg_slam_component.cpp:617-625). `timeout=None` calls inline."""
        with self._lock:
            fn = self._services.get(name)
        if fn is None:
            return None
        if timeout is None:
            return fn(req)
        with self._lock:
            if self._executor is None:
                from concurrent.futures import ThreadPoolExecutor
                self._executor = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="inproc-bus")
        from concurrent.futures import TimeoutError as FutTimeout
        try:
            return self._executor.submit(fn, req).result(timeout=timeout)
        except FutTimeout:
            return None


class SocketServer:
    """Serves a robot's services (e.g. publish_graph) over TCP.

    Protocol: request = ("call", service_name, payload); response = payload.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._services: Dict[str, Callable] = {}
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.address = self._srv.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def advertise(self, name: str, fn: Callable) -> None:
        self._services[name] = fn

    def _serve(self) -> None:
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            while True:
                kind, name, payload = _recv_msg(conn)
                if kind != "call":
                    break
                fn = self._services.get(name)
                _send_msg(conn, fn(payload) if fn else None)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)
        self._srv.close()


class SocketClient:
    """Calls a remote robot's services with a timeout (the 20 s service
    timeout of mrg_slam_component.cpp:618)."""

    def __init__(self, address, timeout: float = 20.0):
        self.address = tuple(address)
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self.address, timeout=self.timeout)
            s.settimeout(self.timeout)
            self._sock = s
        return self._sock

    def call(self, name: str, req):
        with self._lock:
            try:
                sock = self._connect()
                _send_msg(sock, ("call", name, req))
                return _recv_msg(sock)
            except (ConnectionError, OSError, socket.timeout):
                self._sock = None
                return None

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None
