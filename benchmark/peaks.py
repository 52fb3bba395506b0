"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit), against which every share of a peak or roofline is read."""

# a configuration's dtype -> the tensor cores' peak for its operands
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12}
HBM_BYTES_PER_S = 3.35e12
