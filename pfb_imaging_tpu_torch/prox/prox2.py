"""Ridge prox (port of pfb_imaging_tpu/prox/prox2.py): prox of (gamma/2)||x||^2."""


def prox2(x, gamma):
    return x / (1.0 + gamma)
