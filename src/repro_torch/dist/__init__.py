"""The LM-scale DFL round (the one-pod form of the pod round; the
torch.distributed pod ring is ROADMAP A.10)."""
