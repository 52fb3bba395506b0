"""The plain reference of the benchmark: copies of the port's model modules
as they stood when the benchmark was defined (vexpress_torch/models, the
GEGLU and embedding layers, the samplers, the context windows and the audio
windowing), frozen here so that a later change to the program cannot change
its yardstick, with plain fp32 attention in place of the port's kernels, a
plain decode tail (`media`), the plain pipeline (`pipeline`) and the fp8
control (`lowp`). Nothing here imports the port."""
