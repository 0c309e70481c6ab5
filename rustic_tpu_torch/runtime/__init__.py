"""rustic_tpu_torch.runtime"""
