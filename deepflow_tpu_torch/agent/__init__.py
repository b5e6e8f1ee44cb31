"""Agent side: configuration, the frame sink, the durable sender, the
OnCPU sampler and the in-process Agent."""
