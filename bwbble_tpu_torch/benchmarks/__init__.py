"""The row-fetch probes of the design on the CUDA device: dependent row waves
(`dma_probe`), a digest over rows gathered in four layouts
(`gather_pallas_probe`) and a plain row gather (`gather_bench`), each run
as `python -m bwbble_tpu_torch.benchmarks.<probe>`.  Their hand-written
kernels are csrc/probes.cu, bound in `kernels`."""
