"""Published peaks of the cards the benchmark runs on (dense rates, no
sparsity), by the name ``torch.cuda.get_device_name()`` gives. They hold
at the card's full power limit; a run records the limit beside them."""

PEAKS = {
    # NVIDIA H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s
    # float32 outside the tensor cores
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}
