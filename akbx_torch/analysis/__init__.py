from akbx_torch.analysis import legendre, psf, rectify  # noqa: F401
