"""The benchmark's frozen yardstick: the H100's peaks, the matmul FLOPs of
a train step and of a decode, and the least time a kernel could take,
copied from the port's measuring programs so that later changes to the
program cannot move them."""
