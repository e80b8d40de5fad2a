from .misc import (  # noqa: F401
    PROF,
    batch_iter,
    cdiv,
    full_fast,
    pick_bucket,
    pow2_rows,
    prof_timer,
    progress_bar,
    round_up,
)
