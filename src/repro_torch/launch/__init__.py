"""Runtime device selection and sync accounting."""
from .platform import (default_device, device_fetch, reset_sync_count,
                       resolve_device, sync_count)

__all__ = ["default_device", "device_fetch", "reset_sync_count",
           "resolve_device", "sync_count"]
