"""Host-side data layer: replay buffers (with the native episode store) and
image utils."""

from v2a_tpu_torch.data.replay_buffer import EpisodeBuffer, ReplayBuffer

__all__ = ["EpisodeBuffer", "ReplayBuffer"]
