"""Device operations of the port: FFTs, filter banks, OF fits, trace
statistics, the continuous-data trigger, and the hand-written CUDA
kernels behind them."""
