"""NVIDIA H100 SXM5 80 GB constants (the port's roofline target), under
the reference's names.

Source: NVIDIA H100 Tensor Core GPU datasheet (H100 SXM column): 989.4
TFLOP/s dense BF16 tensor-core throughput (1,979 with 2:4 sparsity),
3.35 TB/s of HBM3 bandwidth, 80 GB of HBM3, and fourth-generation NVLink
at 900 GB/s of total bandwidth per GPU over 18 links.  An HGX H100 board
joins 8 GPUs all to all through NVSwitch: one NVLink domain.
"""

PEAK_FLOPS_BF16 = 989e12        # per GPU, dense bf16 (tensor cores)
HBM_BW = 3.35e12                # bytes/s per GPU
#: bytes/s per NVLink link, one direction: 900 GB/s over 18 links is 50
#: GB/s per link both ways, 25 GB/s each way.  It stands where the
#: reference's per-link ICI rate stands: the rate one collective's ring
#: step puts on one link.
ICI_LINK_BW = 25e9
HBM_BYTES = 80e9                # 80 GB per GPU

CHIPS_PER_POD = 8               # GPUs of one NVLink domain (HGX H100)
