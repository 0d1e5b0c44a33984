"""Environment layer: the EnvList interface, the deterministic fake backend,
the LIBERO/MuJoCo adapter (`envs/libero.py`, imported only when a LIBERO
list is built) and the name registry (copies of `v2a_tpu/envs/`)."""

from v2a_tpu_torch.envs.base import EnvList
from v2a_tpu_torch.envs.fake import FakeEnvList
from v2a_tpu_torch.envs.registration import make_env_list, register_env_list

__all__ = ["EnvList", "FakeEnvList", "make_env_list", "register_env_list"]
