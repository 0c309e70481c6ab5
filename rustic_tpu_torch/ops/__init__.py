"""rustic_tpu_torch.ops"""
