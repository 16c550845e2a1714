"""The span timer, the host thread pool and the MSM window autotune."""
