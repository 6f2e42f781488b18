"""ring_skew.wave: how far the ring's ranks drift apart (%): the slowest
rank's median span of a whole stage less the fastest's, over the
slowest's."""


def read(rec):
    ms = rec.get("rank_stage_ms")
    if not ms or max(ms) <= 0:
        return None
    return 100.0 * (max(ms) - min(ms)) / max(ms)
