"""wave_pairs_per_s: the source-target pairs of every stage the window
completed, over the window's seconds."""


def read(rec):
    return (rec["work"] / rec["window_s"] if rec["work_unit"] == "pairs"
            else None)
