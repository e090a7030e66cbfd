"""Loaders of the port (see loader/base.py) and the device feed
(loader/device_feed.py)."""

from veles_tpu_torch.loader.base import (  # noqa: F401
    TEST, TRAIN, VALIDATION, Loader, PrefetchingLoader)
from veles_tpu_torch.loader.device_feed import DeviceFeed  # noqa: F401
