from distributed_ml_pytorch_tpu_torch.models.cnn import AlexNet, LeNet, get_model

__all__ = ["AlexNet", "LeNet", "get_model"]
