from active_tracking_rl_torch.envs.types import EnvState  # noqa: F401
from active_tracking_rl_torch.envs.env import TrackEnv, make_env  # noqa: F401
