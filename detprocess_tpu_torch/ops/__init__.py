"""Device operations of the port: FFTs, filter banks, OF fits, trace
statistics, and the hand-written CUDA kernels behind them."""
