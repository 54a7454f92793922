"""Several bands or devices at once (port of pfb_imaging_tpu/parallel/).

Only the multiband IDG residual is ported (``sharded``); the device mesh,
the row-sharded FFT and multi-host runs are still to come (ROADMAP.md,
queue A)."""
