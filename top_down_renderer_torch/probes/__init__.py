"""Hardware probes of the card: the counterparts of the TPU's probe
kernels in tests/ (probe_dma_*.py, probe_int8*.py, exp_crop_ablate.py).

  window       window_gather (csrc/probe_window.cu): copy or sum windows
               of a stacked map in a chosen fetch geometry
  mm           mm_s8, mm_bf16 (csrc/probe_mm.cu): products on the tensor
               cores in int8 and bf16
  crop_ablate  crop_ablate, crop_ablate_multi (csrc/crop_ablate.cu): the
               tracked crop kernel with stages knocked out

Each kernel has its plain version beside it; `python -m
top_down_renderer_torch.probes` runs them all on the card (__main__.py).
Import the submodules (probes.window, probes.mm, probes.crop_ablate).
"""
