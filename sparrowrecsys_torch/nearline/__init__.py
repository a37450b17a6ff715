"""The nearline plane: the streaming latest-behaviour feature."""

from sparrowrecsys_torch.nearline.stream import (
    FileWatchSource,
    LatestRatingStream,
    RatingEvent,
    attach_to_store,
)
