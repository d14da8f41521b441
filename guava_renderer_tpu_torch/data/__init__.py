"""The tracked-video data layer (counterpart of `guava_renderer_tpu/data`)."""

from .loader import PrefetchLoader  # noqa: F401
from .store import RecordStore, RecordStoreWriter  # noqa: F401
from .tracked import TrackedVideoDataset, build_dataset  # noqa: F401
