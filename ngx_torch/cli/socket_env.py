"""JSON-over-TCP env server — wire-compatible with the reference's
``tests/socket_env.py:23-51`` demo (action name in, ``{'observation',
'reward', 'done'}`` JSON out, one client, port 9000); the port of
``ngx/cli/socket_env.py``, byte for byte on the wire.

    python -m ngx_torch.cli.socket_env -env NovelGridworld-v6 -port 9000

The env is the single-env facade (:mod:`ngx_torch.compat`) on ``-device``,
``cuda`` by default, where ngx's server takes ``-platform`` (default cpu).
"""

from __future__ import annotations

import argparse
import json
import socket

from .enjoy import DEVICE_HELP


def recv_socket_data(sock, buff=4096):
    data = b""
    while True:
        part = sock.recv(buff)
        data += part
        if len(part) < buff:
            break
    return data


def serve(env, host="127.0.0.1", port=9000, render=False, max_steps=None):
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    sock.listen()
    print(f"serving {env.env_id} on {host}:{port}")
    conn, addr = sock.accept()
    print("Connected with agent: ", addr)

    env.reset()
    steps = 0
    try:
        while max_steps is None or steps < max_steps:
            action = recv_socket_data(conn).decode().strip()
            if not action:
                break
            action_id = env.actions_id[action]
            obs, reward, done, info = env.step(action_id)
            msg = {"observation": str(obs), "reward": reward, "done": done}
            conn.sendall(str.encode(json.dumps(msg) + "\n"))
            if render:
                env.render()
            steps += 1
    finally:
        conn.close()
        sock.close()
        env.close()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-env", default="NovelGridworld-v6")
    p.add_argument("-host", default="127.0.0.1")
    p.add_argument("-port", type=int, default=9000)
    p.add_argument("-render", action="store_true")
    p.add_argument("-max_steps", type=int, default=None)
    p.add_argument("-device", default="cuda", help=DEVICE_HELP)
    args = p.parse_args(argv)

    from .. import compat as C
    serve(C.make(args.env, device=args.device), args.host, args.port,
          args.render, args.max_steps)


if __name__ == "__main__":
    main()
