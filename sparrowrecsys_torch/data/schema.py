"""Column names of the sample schema the serving assembler fills
(a copy of `sparrowrecsys_tpu/data/schema.py::HISTORY_COLUMNS`)."""

HISTORY_COLUMNS = [
    "userRatedMovie1", "userRatedMovie2", "userRatedMovie3",
    "userRatedMovie4", "userRatedMovie5",
]
