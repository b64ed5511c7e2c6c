"""Random agent speaking the socket-env protocol — the reference's
``tests/socket_agent.py`` counterpart; the port of
``ngx/cli/socket_agent.py``.

    python -m ngx_torch.cli.socket_agent -env NovelGridworld-v6 -port 9000 \\
        -steps 100

Its env (the facade on ``-device``, ``cuda`` by default) only samples the
actions, from ``np.random`` as ngx's does.  The client helpers below
(:func:`connect`, :func:`recv_line`, :func:`serve_and_talk`) speak the
same protocol for a caller that serves an env in process.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import socket
import threading
import time

from .enjoy import DEVICE_HELP


def free_port(host="127.0.0.1") -> int:
    """A port the OS reports free now."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def connect(host, port, deadline=30.0):
    """A client socket to a server that may still be starting: retried
    until it listens or ``deadline`` seconds pass."""
    end = time.monotonic() + deadline
    while True:
        try:
            return socket.create_connection((host, port), timeout=deadline)
        except OSError:
            if time.monotonic() > end:
                raise
            time.sleep(0.05)


def recv_line(sock) -> bytes:
    """One reply: the bytes up to and including its newline."""
    data = b""
    while not data.endswith(b"\n"):
        part = sock.recv(4096)
        if not part:
            break
        data += part
    return data


def serve_and_talk(serve, env, actions, host="127.0.0.1", deadline=60.0):
    """Serve ``env`` with ``serve`` (a ``socket_env.serve``) on a free port
    in a thread, send ``actions`` one at a time, and return the raw reply
    lines and the seconds of the round trips.  The server's prints are
    swallowed; raises if it has not stopped ``deadline`` seconds after the
    last reply."""
    port = free_port(host)
    th = threading.Thread(target=serve, daemon=True, kwargs=dict(
        env=env, host=host, port=port, max_steps=len(actions)))
    with contextlib.redirect_stdout(io.StringIO()):
        th.start()
        sock = connect(host, port, deadline)
        replies = []
        t0 = time.perf_counter()
        try:
            for a in actions:
                sock.sendall(a.encode())
                replies.append(recv_line(sock))
        finally:
            sock.close()
        secs = time.perf_counter() - t0
        th.join(timeout=deadline)
    if th.is_alive():
        raise RuntimeError("the socket server did not stop")
    return replies, secs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-env", default="NovelGridworld-v6")
    p.add_argument("-host", default="127.0.0.1")
    p.add_argument("-port", type=int, default=9000)
    p.add_argument("-steps", type=int, default=100)
    p.add_argument("-device", default="cuda", help=DEVICE_HELP)
    args = p.parse_args(argv)

    from .. import compat as C
    env = C.make(args.env, device=args.device)

    sock = connect(args.host, args.port)
    try:
        for _ in range(args.steps):
            action_id = env.action_space.sample()
            action = env.spec.actions[action_id]
            print("Sending action: ", action_id, action)
            sock.send(str.encode(action))
            observation = recv_line(sock).decode()
            print("Received observation: ", observation[:120])
    finally:
        sock.close()


if __name__ == "__main__":
    main()
