"""Episode logging in stable-baselines Monitor CSV format — the port of
``ngx/utils/monitor.py``.

The reference trains with ``Monitor(env, log_dir)`` and reads the CSVs back
with ``load_results``/``ts2xy`` (reference tests/train.py:109,58-70 and
tests/plot_results.py:29).  :class:`Monitor` wraps an
:mod:`ngx_torch.compat` env and writes ngx's file: a ``#{json}`` header
line, then one ``r,l,t`` row per episode.  :func:`load_results` also reads
the ``progress.monitor.csv`` that ``python -m ngx_torch.cli.train``
writes.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Optional

import numpy as np


class Monitor:
    """Wraps an ngx_torch.compat env; appends one CSV row (r, l, t) per
    episode."""

    EXT = "monitor.csv"

    def __init__(self, env, log_dir: str, filename: Optional[str] = None):
        self.env = env
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, filename or self.EXT)
        if not path.endswith(self.EXT):
            path = path + "." + self.EXT
        self._t0 = time.time()
        self._f = open(path, "w", newline="")
        self._f.write("#%s\n" % json.dumps(
            {"t_start": self._t0, "env_id": env.env_id}))
        self._w = csv.DictWriter(self._f, fieldnames=("r", "l", "t"))
        self._w.writeheader()
        self._f.flush()
        self._ep_r = 0.0
        self._ep_l = 0

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, **kw):
        self._ep_r = 0.0
        self._ep_l = 0
        return self.env.reset(**kw)

    def step(self, action):
        obs, r, done, info = self.env.step(action)
        self._ep_r += r
        self._ep_l += 1
        if done:
            self._w.writerow({"r": round(self._ep_r, 6), "l": self._ep_l,
                              "t": round(time.time() - self._t0, 6)})
            self._f.flush()
        return obs, r, done, info

    def close(self):
        self._f.close()
        self.env.close()


def load_results(log_dir: str):
    """All monitor.csv rows under ``log_dir`` as a list of dicts, sorted by
    time (stable-baselines load_results equivalent)."""
    rows = []
    for root, _, files in os.walk(log_dir):
        for fn in files:
            if fn.endswith(Monitor.EXT):
                with open(os.path.join(root, fn)) as f:
                    header = f.readline()
                    assert header.startswith("#"), "not a monitor file"
                    for row in csv.DictReader(f):
                        rows.append({"r": float(row["r"]),
                                     "l": int(float(row["l"])),
                                     "t": float(row["t"])})
    rows.sort(key=lambda x: x["t"])
    return rows


def ts2xy(rows, xaxis: str = "timesteps"):
    """(x, y) arrays from monitor rows (stable-baselines ts2xy
    equivalent)."""
    y = np.asarray([r["r"] for r in rows])
    if xaxis == "timesteps":
        x = np.cumsum([r["l"] for r in rows])
    elif xaxis == "episodes":
        x = np.arange(len(rows))
    else:  # walltime_hrs
        x = np.asarray([r["t"] for r in rows]) / 3600.0
    return x, y
