"""Socket transport: length-prefixed pickled messages with request/reply.

The port's own copy of `ray_tpu/_private/protocol.py`, on one node:
every process exposes one `AF_UNIX` socket server, and peers hold direct
persistent connections. Messages are Python dicts with a `kind` field,
pickled with protocol 5 and framed by a little-endian u64 length.
Requests carry a `seq`; replies echo it as `reply_to`. The runtime's
addresses are in Linux's abstract socket namespace (a leading NUL byte),
so no socket file outlives a session. An abstract socket has no file
permissions, so both ends check the peer's `SO_PEERCRED` uid against
their own before a byte of the peer's is unpickled: a process of
another user is refused (`PeerRefused`). The first message on every
connection is `{"kind": "hello", "addr": <the dialler's own server
address>, ...}`.

The reference's TCP plane, chaos hooks, serialize hooks and out-of-band
frames belong to its multi-node data plane and are not copied: large
values move through the shared-memory object store, never over a
socket.
"""

from __future__ import annotations

import logging
import os
import pickle
import socket
import struct
import threading
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)

_LEN = struct.Struct("<Q")
PICKLE_PROTOCOL = 5


class ConnectionClosed(Exception):
    pass


class PeerRefused(ConnectionClosed, PermissionError):
    """The peer runs as another user."""


_PEERCRED = struct.Struct("3i")  # struct ucred: pid, uid, gid


def _peer_uid(sock: socket.socket) -> int:
    _, uid, _ = _PEERCRED.unpack(sock.getsockopt(
        socket.SOL_SOCKET, socket.SO_PEERCRED, _PEERCRED.size))
    return uid


def _check_peer(sock: socket.socket) -> None:
    """Refuse a peer of another user: its messages are pickles, and
    unpickling runs code."""
    uid = _peer_uid(sock)
    if uid != os.getuid():
        raise PeerRefused(f"peer uid {uid} is not this process's "
                          f"uid {os.getuid()}")


def _send_msg(sock: socket.socket, payload: bytes) -> None:
    header = _LEN.pack(len(payload))
    if len(payload) < 1 << 16:
        sock.sendall(header + payload)
        return
    # Scatter-gather: no concatenation copy of a large payload onto its
    # header; sendmsg may take part of the frame, so loop.
    parts = [memoryview(header), memoryview(payload).cast("B")]
    while parts:
        sent = sock.sendmsg(parts)
        while sent and parts:
            if sent >= parts[0].nbytes:
                sent -= parts[0].nbytes
                parts.pop(0)
            else:
                parts[0] = parts[0][sent:]
                sent = 0


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionClosed()
        got += r
    return buf


def _recv_msg(sock: socket.socket) -> bytearray:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return _recv_exact(sock, n)


class _ReplyFuture:
    __slots__ = ("_ev", "_value", "_exc")

    def __init__(self):
        self._ev = threading.Event()
        self._value = None
        self._exc = None

    def set(self, value):
        self._value = value
        self._ev.set()

    def set_exception(self, exc):
        self._exc = exc
        self._ev.set()

    def result(self, timeout=None):
        if not self._ev.wait(timeout):
            raise TimeoutError("rpc timed out")
        if self._exc is not None:
            raise self._exc
        return self._value


class Connection:
    """A bidirectional message channel to one peer.

    One background thread reads messages; `kind == "reply"` resolves a
    pending request's future, everything else goes to
    `handler(conn, msg)`. Handlers must be fast or hand off to their own
    thread.
    """

    def __init__(self, sock: socket.socket, handler: Callable,
                 peer_addr: str = "", on_close: Optional[Callable] = None):
        self.sock = sock
        self.handler = handler
        self.peer_addr = peer_addr  # the peer's server address
        self.on_close = on_close
        self.closed = False
        self._send_lock = threading.Lock()
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._pending: Dict[int, _ReplyFuture] = {}
        self._thread = threading.Thread(
            target=self._recv_loop, daemon=True,
            name=f"conn-recv-{os.path.basename(peer_addr)}")
        self._thread.start()

    # -- sending ---------------------------------------------------------
    def send(self, msg: dict) -> None:
        payload = pickle.dumps(msg, protocol=PICKLE_PROTOCOL)
        try:
            with self._send_lock:
                _send_msg(self.sock, payload)
        except (OSError, ConnectionClosed) as e:
            self._handle_close()
            raise ConnectionClosed(str(e)) from e

    def request(self, msg: dict, timeout: Optional[float] = None) -> dict:
        """Send a message and block for its reply; raises the reply's
        `error` if it carries one."""
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        fut = _ReplyFuture()
        self._pending[seq] = fut
        msg = dict(msg, seq=seq)
        try:
            self.send(msg)
            reply = fut.result(timeout)
        finally:
            self._pending.pop(seq, None)
        if reply.get("error") is not None:
            raise reply["error"]
        return reply

    def reply(self, req: dict, **fields) -> None:
        self.send({"kind": "reply", "reply_to": req["seq"], **fields})

    # -- receiving -------------------------------------------------------
    def _recv_loop(self):
        try:
            while True:
                payload = _recv_msg(self.sock)
                msg = pickle.loads(payload)
                if msg.get("kind") == "reply":
                    fut = self._pending.get(msg["reply_to"])
                    if fut is not None:
                        fut.set(msg)
                else:
                    try:
                        self.handler(self, msg)
                    except Exception:  # noqa: BLE001 — keep the channel up
                        logger.exception("error handling %s",
                                         msg.get("kind"))
                # Drop the message now, not when the next one arrives:
                # the ObjectRefs in it count toward their objects' lives.
                payload = msg = None
        except (ConnectionClosed, OSError, EOFError, pickle.UnpicklingError):
            pass
        except Exception:  # noqa: BLE001 — a message that fails to load
            logger.exception("connection to %s lost", self.peer_addr)
        finally:
            self._handle_close()

    def _handle_close(self):
        if self.closed:
            return
        self.closed = True
        try:
            # close() alone does not unblock a recv() in another thread.
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        for fut in list(self._pending.values()):
            fut.set_exception(
                ConnectionClosed(f"peer {self.peer_addr} closed"))
        if self.on_close is not None:
            try:
                self.on_close(self)
            except Exception:  # noqa: BLE001
                logger.exception("on_close callback failed")

    def close(self):
        self._handle_close()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=1.0)


class Server:
    """Unix-socket accept loop; each accepted socket becomes a
    Connection keyed by the peer's advertised address (its hello)."""

    def __init__(self, path: str, handler: Callable,
                 on_connect: Optional[Callable] = None,
                 on_close: Optional[Callable] = None):
        self.path = path
        self.handler = handler
        self.on_connect = on_connect
        self.on_close = on_close
        if not path.startswith("\0"):
            # Addresses are in Linux's abstract namespace: no file to
            # make or unlink.
            raise ValueError(f"not an abstract socket address: {path!r}")
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(256)
        self.connections: Dict[str, Connection] = {}
        self._lock = threading.Lock()
        self._stopped = False
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"server-{os.path.basename(path)}")
        self._thread.start()

    def _accept_loop(self):
        while not self._stopped:
            try:
                sock, _ = self._sock.accept()
            except OSError:
                break
            threading.Thread(target=self._handshake, args=(sock,),
                             daemon=True).start()

    def _handshake(self, sock: socket.socket):
        try:
            _check_peer(sock)
        except PeerRefused as e:
            logger.warning("refused a connection to %r: %s", self.path, e)
            sock.close()
            return
        try:
            hello = pickle.loads(_recv_msg(sock))
            assert hello.get("kind") == "hello", hello
        except Exception:  # noqa: BLE001 — not a peer of ours
            sock.close()
            return
        conn = Connection(sock, self.handler, hello.get("addr", ""),
                          on_close=self._on_conn_close)
        with self._lock:
            self.connections[conn.peer_addr] = conn
        if self.on_connect is not None:
            self.on_connect(conn, hello)

    def _on_conn_close(self, conn: Connection):
        with self._lock:
            if self.connections.get(conn.peer_addr) is conn:
                del self.connections[conn.peer_addr]
        if self.on_close is not None:
            self.on_close(conn)

    def close(self):
        self._stopped = True
        try:
            # shutdown() is what unblocks the accept() on Linux.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self.connections.values())
        for c in conns:
            c.close()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=1.0)


def connect(path: str, my_addr: str, handler: Callable,
            hello_extra: Optional[dict] = None,
            on_close: Optional[Callable] = None,
            timeout: float = 30.0) -> Connection:
    """Dial a peer's server and perform the hello handshake."""
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    sock.connect(path)
    sock.settimeout(None)
    try:
        _check_peer(sock)
    except PeerRefused:
        sock.close()
        raise
    hello = {"kind": "hello", "addr": my_addr, **(hello_extra or {})}
    _send_msg(sock, pickle.dumps(hello, protocol=PICKLE_PROTOCOL))
    return Connection(sock, handler, peer_addr=path, on_close=on_close)
