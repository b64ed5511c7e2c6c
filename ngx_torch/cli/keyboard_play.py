"""Interactive human play — the reference's ``tests/keyboard_interface.py``
rebuilt without the root-only ``keyboard`` dependency; the port of
``ngx/cli/keyboard_play.py``.  It reads single keys from stdin (or full
action names) and prints the obs/inventory/step-cost HUD.

    python -m ngx_torch.cli.keyboard_play -env NovelGridworld-Pogostick-v1 \\
        [-novelty axe -difficulty easy -arg1 wooden] [-render] [-device cpu]

The env is the single-env facade (:mod:`ngx_torch.compat`) on ``-device``,
``cuda`` by default, where ngx's driver takes ``-platform`` (default cpu).
"""

from __future__ import annotations

import argparse

import numpy as np

from .enjoy import DEVICE_HELP


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-env", default="NovelGridworld-Pogostick-v1")
    p.add_argument("-novelty", default="")
    p.add_argument("-difficulty", default="hard")
    p.add_argument("-arg1", default="")
    p.add_argument("-arg2", default="")
    p.add_argument("-render", action="store_true")
    p.add_argument("-seed", type=int, default=-1)
    p.add_argument("-device", default="cuda", help=DEVICE_HELP)
    args = p.parse_args(argv)

    from .. import compat as C
    from ..compat.constant import assign_keys

    if args.seed >= 0:
        np.random.seed(args.seed)
    env = C.make(args.env, device=args.device)
    if args.novelty:
        env = C.inject_novelty(env, args.novelty, args.difficulty,
                               args.arg1, args.arg2)
    keys = assign_keys(env)
    id_to_name = {v: k for k, v in env.actions_id.items()}

    print("Key bindings:")
    for k, aid in sorted(keys.items(), key=lambda kv: kv[1]):
        print(f"  {k:>6} -> {id_to_name[aid]}")
    print("type a key (or a full action name, or 'quit') and press enter\n")

    env.reset()
    if args.render:
        env.render()
    while True:
        try:
            raw = input("action> ").strip()
        except EOFError:
            break
        if raw in ("quit", "exit", "q!"):
            break
        if raw in keys:
            action_id = keys[raw]
        elif raw in env.actions_id:
            action_id = env.actions_id[raw]
        else:
            print("unknown key/action:", raw)
            continue
        obs, reward, done, info = env.step(action_id)
        print(f"action: {id_to_name[action_id]}  reward: {reward}  "
              f"done: {done}  info: {info}")
        print("inventory:", {k: v for k, v in
                             env.inventory_items_quantity.items() if v})
        if args.render:
            env.render()
        if done:
            print("episode over — resetting")
            env.reset()


if __name__ == "__main__":
    main()
