"""Serving in the PyTorch port: the in-process continuous-batching engine
(`llm.ContinuousBatchingEngine`, `llm.LLMReplica`) over a slotted or paged
KV cache. The Serve control plane, proxy and handle come with the runtime
slice."""
