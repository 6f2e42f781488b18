"""align_rays_per_s: the rays of every step the window completed (traced
forward and backward), over the window's seconds."""


def read(rec):
    return (rec["work"] / rec["window_s"] if rec["work_unit"] == "rays"
            else None)
