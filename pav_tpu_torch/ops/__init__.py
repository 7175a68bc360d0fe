"""Device ops of the torch port: affine-gap DP kernels, density FFT, chaining."""
