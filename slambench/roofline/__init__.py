"""The yardstick for the program's hand-written kernels: the chip's
published peaks and, per kernel, the operations and bytes its inputs
need."""
