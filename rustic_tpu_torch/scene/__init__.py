"""rustic_tpu_torch.scene"""
