"""Unified typed experiment configuration.

A copy of `v2a_tpu/config/experiment.py` over the port's config classes,
with one more field, `device` (None = the card; "cpu" when asked).

The reference uses three cooperating config systems (SURVEY §5): Python-dict
config modules merged by a Tap `Parser` with CLI overrides
(`diffuser/utils/setup.py:49-222`), OmegaConf YAML for the policy net
(`diffuser/diffusion_policy/get_dp.py:10-104`), and pickled lazy `Config`
constructors as the on-disk persistence format
(`diffuser/utils/config.py:18-75`). Here they unify into ONE dataclass tree
with the same three capabilities:

- **Python-file experiment configs**: a module defining `base = {...}` whose
  nested keys override dataclass defaults (`load_config_module`);
- **CLI override semantics**: `--a.b.c value` dotted paths with type
  coercion by the old value's type (`apply_overrides`, mirroring
  `setup.py:127-160`);
- **on-disk snapshot for eval reload**: JSON instead of pickle
  (`save_snapshot` / `load_snapshot`) — the train→eval contract the
  reference implements with `{dataset,trainer}_config.pkl`
  (`diffuser/utils/config.py:33-37`, `lb_eval_utils.py:14-16`).

Experiment naming follows the `watch()` convention (`setup.py:25-46`).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from v2a_tpu_torch.eval.harness import EvalConfig
from v2a_tpu_torch.models.policy import PolicyConfig
from v2a_tpu_torch.models.video_model import VideoModelConfig
from v2a_tpu_torch.train.explore import ExploreConfig
from v2a_tpu_torch.train.train_state import EMAConfig, OptimizerConfig
from v2a_tpu_torch.train.trainer import TrainerConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Everything one experiment needs, mirroring the surface of
    `config/libero/lb_tk8_65to72.py`."""

    dataset: str = "libero-8tk-65to72-v3"
    seed: int = 0
    logbase: str = "logs"
    prefix: str = "diffusion/"
    exp_name: str = ""  # generated when empty
    config_fn: str = ""
    video_ckpt_dir: str = "./ckpts/libero/libero_ep20_bs12_aug"
    video_ckpt_milestone: int = 180000
    do_train_resume: bool = False
    env_backend: str = "libero"  # or "fake" for hermetic runs
    # "diffusion" = the frozen video diffusion model (the release);
    # "oracle" = the scripted ground-truth goal-frame generator for the
    # fake world (envs/fake_oracle.py) — the hermetic stand-in the
    # learning gate trains against (requires env_backend == "fake")
    video_model_kind: str = "diffusion"
    # device mesh for multi-card training: axis names + shape, e.g.
    # ("dp",) / ("dp", "tp") with (2, 2) on four ranks; empty = single
    # device. "auto_dp" spans the world with one dp axis.
    mesh_axes: Tuple[str, ...] = ()
    mesh_shape: Tuple[int, ...] = ()
    # subprocess env workers for pool-parallel exploration (0 = serial)
    n_env_workers: int = 0
    # where the models run: None = the card ("cuda"), "cpu" when asked
    device: Optional[str] = None

    policy: PolicyConfig = dataclasses.field(default_factory=PolicyConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    explore: ExploreConfig = dataclasses.field(default_factory=ExploreConfig)
    video: VideoModelConfig = dataclasses.field(default_factory=VideoModelConfig)
    opt: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    ema: EMAConfig = dataclasses.field(default_factory=EMAConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)

    # -- (de)serialization -------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        return _dataclass_from_dict(cls, d)

    def savepath(self) -> str:
        name = self.exp_name or generate_exp_name(self)
        return os.path.join(self.logbase, self.dataset, self.prefix, name)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


_SUB_CONFIGS = {
    "policy": PolicyConfig,
    "trainer": TrainerConfig,
    "explore": ExploreConfig,
    "video": VideoModelConfig,
    "opt": OptimizerConfig,
    "ema": EMAConfig,
    "eval": EvalConfig,
}


def _coerce_tuples(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """JSON round-trips tuples as lists; coerce back per field type."""
    out = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in kwargs.items():
        if k not in fields:
            raise KeyError(
                f"unknown config key '{k}' for {cls.__name__}; valid: "
                f"{sorted(fields)}"
            )
        default = fields[k].default
        if isinstance(v, list) and (
            isinstance(default, tuple)
            or fields[k].default_factory is not dataclasses.MISSING  # type: ignore
        ):
            v = _list_to_tuple(v)
        out[k] = v
    return out


def _list_to_tuple(v):
    if isinstance(v, list):
        return tuple(_list_to_tuple(x) for x in v)
    return v


def _fixup_int_key_dicts(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """JSON stringifies int dict keys (e.g. the per-task grasp table
    `act_down_val_range_per_tk`); restore them for every field whose type
    hint is Dict[int, ...]."""
    import typing

    try:
        hints = typing.get_type_hints(cls)
    except Exception:
        return kwargs
    for name, hint in hints.items():
        if name not in kwargs or not isinstance(kwargs[name], dict):
            continue
        args = typing.get_args(_strip_optional(hint))
        if args and args[0] is int:
            kwargs[name] = {
                int(k): _list_to_tuple(v) if isinstance(v, list) else v
                for k, v in kwargs[name].items()
            }
    return kwargs


def _strip_optional(hint):
    import typing

    if typing.get_origin(hint) is typing.Union:
        non_none = [a for a in typing.get_args(hint) if a is not type(None)]
        if len(non_none) == 1:
            return non_none[0]
    return hint


def _dataclass_from_dict(cls, d: Dict[str, Any]):
    kwargs: Dict[str, Any] = {}
    for k, v in d.items():
        if k in _SUB_CONFIGS and isinstance(v, dict):
            sub_cls = _SUB_CONFIGS[k]
            kwargs[k] = sub_cls(
                **_fixup_int_key_dicts(sub_cls, _coerce_tuples(sub_cls, v))
            )
        else:
            kwargs[k] = v
    if cls is ExperimentConfig:
        # coerce top-level simple fields too
        top = {k: v for k, v in kwargs.items() if k not in _SUB_CONFIGS}
        top = _coerce_tuples(cls, {**top})
        kwargs.update(top)
    return cls(**kwargs)


# -- Python-file experiment configs ---------------------------------------


def load_config_module(path: str, experiment: str = "base") -> ExperimentConfig:
    """Import a config `.py` file and build the typed tree from its `base`
    dict (the reference's `read_config`, `setup.py:85-125`).

    The module must define `base: dict` (optionally with per-experiment
    sub-dicts selected by `experiment`)."""
    spec = importlib.util.spec_from_file_location("exp_config", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    base = getattr(module, "base")
    if experiment != "base" and experiment in base:
        base = base[experiment]
    cfg = ExperimentConfig.from_dict(base)
    if not cfg.config_fn:
        cfg = cfg.replace(
            config_fn=os.path.splitext(os.path.basename(path))[0]
        )
    return cfg


# -- CLI overrides ---------------------------------------------------------


def _coerce_like(old: Any, raw: str) -> Any:
    """Type coercion by the overridden value's type (`setup.py:140-158`)."""
    if isinstance(old, bool):
        if raw.lower() in ("1", "true", "yes"):
            return True
        if raw.lower() in ("0", "false", "no"):
            return False
        raise ValueError(f"cannot parse bool from {raw!r}")
    if isinstance(old, int) and not isinstance(old, bool):
        return int(float(raw))
    if isinstance(old, float):
        return float(raw)
    if isinstance(old, (tuple, list)):
        import ast

        return _list_to_tuple(ast.literal_eval(raw))
    if old is None:
        import ast

        try:
            return ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            return raw
    return raw


def apply_overrides(
    cfg: ExperimentConfig, overrides: Dict[str, str]
) -> ExperimentConfig:
    """Apply dotted-path CLI overrides, e.g.
    {'trainer.n_train_steps': '100', 'seed': '3'}."""
    d = cfg.to_dict()
    for dotted, raw in overrides.items():
        parts = dotted.split(".")
        node = d
        for p in parts[:-1]:
            if p not in node:
                raise KeyError(f"unknown config path '{dotted}'")
            node = node[p]
        leaf = parts[-1]
        if leaf not in node:
            raise KeyError(f"unknown config path '{dotted}'")
        node[leaf] = (
            _coerce_like(node[leaf], raw) if isinstance(raw, str) else raw
        )
    return ExperimentConfig.from_dict(d)


def parse_cli(argv: Sequence[str]) -> Tuple[Optional[str], Dict[str, str]]:
    """Split argv into (--config path, {dotted_key: raw_value}).

    Mirrors the reference CLI: every `--key value` pair beyond `--config`
    is an override (`setup.py:127-139`)."""
    config_path = None
    overrides: Dict[str, str] = {}
    i = 0
    argv = list(argv)
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"expected --key, got {arg!r}")
        key = arg[2:]
        if i + 1 >= len(argv):
            raise ValueError(f"missing value for --{key}")
        val = argv[i + 1]
        if key == "config":
            config_path = val
        else:
            overrides[key] = val
        i += 2
    return config_path, overrides


# -- experiment naming + snapshot -----------------------------------------


DEFAULT_WATCH = (
    ("config_fn", ""),
    ("policy.horizon", "H"),
    ("policy.num_train_timesteps", "T"),
)


def generate_exp_name(
    cfg: ExperimentConfig,
    watch: Sequence[Tuple[str, str]] = DEFAULT_WATCH,
) -> str:
    """`watch()`-style name: (dotted-arg, label) pairs joined as
    `label{value}` (`diffuser/utils/setup.py:25-46`)."""
    d = cfg.to_dict()
    parts = []
    for dotted, label in watch:
        node: Any = d
        for p in dotted.split("."):
            node = node[p]
        parts.append(f"{label}{node}" if label else str(node))
    return "_".join(p for p in parts if p)


def _git_rev() -> Optional[str]:
    """Current commit (the reference records it per-experiment,
    `setup.py:162-176`)."""
    import subprocess

    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or None
    except Exception:
        return None


SNAPSHOT_NAME = "experiment_config.json"


def save_snapshot(cfg: ExperimentConfig, savepath: Optional[str] = None) -> str:
    """Persist the full config; eval reloads experiments from this file the
    way the reference unpickles `Config` objects."""
    savepath = savepath or cfg.savepath()
    os.makedirs(savepath, exist_ok=True)
    path = os.path.join(savepath, SNAPSHOT_NAME)
    payload = cfg.to_dict()
    payload["_meta"] = {"git_rev": _git_rev()}
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=str)
    return path


def load_snapshot(savepath: str) -> ExperimentConfig:
    path = (
        savepath
        if savepath.endswith(".json")
        else os.path.join(savepath, SNAPSHOT_NAME)
    )
    with open(path) as f:
        d = json.load(f)
    d.pop("_meta", None)
    return ExperimentConfig.from_dict(d)
