"""The yardstick of the kernels' and the step's shares: the chip's published
peaks (:mod:`bench.roofline.peaks`) and the operations and bytes that the
traffic needs of each kernel and of the whole model step
(:mod:`bench.roofline.counts`)."""
