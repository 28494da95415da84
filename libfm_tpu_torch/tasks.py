"""Task constants shared across learners.

Mirrors libFM's task encoding (0=regression, 1=classification),
libFM src/libfm/src/fm_learn.h:46-48.
"""

TASK_REGRESSION = 0
TASK_CLASSIFICATION = 1



def parse_task(s: str) -> int:
    """The CLI's -task flag: 'r' -> regression, 'c' -> classification
    (libFM libfm.cpp:298-309)."""
    if s == "r":
        return TASK_REGRESSION
    if s == "c":
        return TASK_CLASSIFICATION
    raise ValueError(f"unknown task {s!r} (expected 'r' or 'c')")
