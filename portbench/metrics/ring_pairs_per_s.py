"""ring_pairs_per_s: the source-target pairs of every stage the four-card
ring completed, over the window's seconds (``wave_pairs_per_s``'s
reading, under a bound of its own: the ring's runs spread wider)."""


def read(rec):
    return (rec["work"] / rec["window_s"] if rec["work_unit"] == "pairs"
            else None)
