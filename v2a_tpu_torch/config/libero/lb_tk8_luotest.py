"""Fast test-template config: identical to the release config except
`init_rand_steps=100` so the full loop (incl. video exploration) is reached
in minutes — mirrors `config/libero/lb_tk8_luotest.py:6-10,89`.

A copy of the JAX package's file; it loads the port's release config
(`lb_tk8_65to72.py` beside it)."""

import os.path as osp
import importlib.util

_release = osp.join(osp.dirname(__file__), "lb_tk8_65to72.py")
_spec = importlib.util.spec_from_file_location("_release_cfg", _release)
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)

base = _mod.base
base["trainer"] = {**base["trainer"], "init_rand_steps": 100}
