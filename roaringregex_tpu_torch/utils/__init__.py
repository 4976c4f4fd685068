from .config import RrxConfig, get_config, set_config  # noqa: F401
