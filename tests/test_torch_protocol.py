"""The port's socket transport refuses peers of another user.

The runtime's sockets are in Linux's abstract namespace, which has no
file permissions, and every message is a pickle. So `protocol.Server`
and `protocol.connect` read the peer's `SO_PEERCRED` uid first and close
a socket whose uid is not their own before a byte of it is unpickled.
A peer of the same user talks as before. The other user is played by a
patched `_peer_uid`, and, where the tests run as root, by an
interpreter started as uid 65534.
"""

import os
import pickle
import socket
import subprocess
import sys
import time

import pytest

from ray_tpu_torch._private import protocol


class _Mkdir:
    """A message whose unpickling makes `path`: the trace of code run
    on the receiving side."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return os.mkdir, (self.path,)


def _frame(obj) -> bytes:
    payload = pickle.dumps(obj, protocol=protocol.PICKLE_PROTOCOL)
    return protocol._LEN.pack(len(payload)) + payload


def _addr() -> str:
    return f"\0ray_tpu_torch/test/{os.getpid()}-{os.urandom(4).hex()}"


@pytest.fixture
def server():
    handled = []
    srv = protocol.Server(_addr(), lambda conn, msg: handled.append(msg))
    yield srv, handled
    srv.close()


def _closed_by_peer(sock: socket.socket, frame: bytes) -> bool:
    """Send `frame`; whether the peer then closed the socket."""
    sock.settimeout(5.0)
    try:
        sock.sendall(frame)
        return sock.recv(1) == b""
    except (BrokenPipeError, ConnectionResetError):
        return True


def test_same_user_round_trip(server):
    srv, handled = server
    conn = protocol.connect(srv.path, "client", lambda c, m: None)
    try:
        conn.send({"kind": "ping", "n": 1})
        deadline = time.monotonic() + 5
        while not handled and time.monotonic() < deadline:
            time.sleep(0.01)
        assert handled == [{"kind": "ping", "n": 1}]
    finally:
        conn.close()


def test_server_refuses_a_peer_of_another_user(server, monkeypatch,
                                                tmp_path):
    srv, handled = server
    monkeypatch.setattr(protocol, "_peer_uid", lambda sock: os.getuid() + 1)
    marker = str(tmp_path / "unpickled")
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        sock.connect(srv.path)
        assert _closed_by_peer(sock, _frame(
            {"kind": "hello", "addr": "x", "payload": _Mkdir(marker)}))
    finally:
        sock.close()
    assert not os.path.exists(marker)
    assert handled == [] and srv.connections == {}


def test_connect_refuses_a_server_of_another_user(server, monkeypatch):
    srv, _ = server
    monkeypatch.setattr(protocol, "_peer_uid", lambda sock: os.getuid() + 1)
    with pytest.raises(protocol.PeerRefused):
        protocol.connect(srv.path, "client", lambda c, m: None)
    assert srv.connections == {}


_OTHER_USER_CLIENT = """
import socket, sys
sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
sock.connect(bytes.fromhex(sys.argv[1]).decode())
sock.settimeout(5.0)
try:
    sock.sendall(bytes.fromhex(sys.argv[2]))
    closed = sock.recv(1) == b""
except (BrokenPipeError, ConnectionResetError):
    closed = True
sys.exit(0 if closed else 2)
"""


@pytest.mark.skipif(not hasattr(os, "getuid") or os.getuid() != 0,
                    reason="running a process as another uid needs root")
def test_server_refuses_a_real_process_of_another_user(server, tmp_path):
    srv, handled = server
    marker = str(tmp_path / "unpickled")
    frame = _frame({"kind": "hello", "addr": "x", "payload": _Mkdir(marker)})
    # An interpreter of uid 65534 that imports nothing of the repo.
    done = subprocess.run(
        [sys.executable, "-I", "-S", "-c", _OTHER_USER_CLIENT,
         srv.path.encode().hex(), frame.hex()],
        user=65534, group=65534, cwd="/", capture_output=True, timeout=60)
    assert done.returncode == 0, done.stderr
    assert not os.path.exists(marker)
    assert handled == [] and srv.connections == {}
