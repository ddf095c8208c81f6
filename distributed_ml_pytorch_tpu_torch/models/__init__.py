from distributed_ml_pytorch_tpu_torch.models.cnn import AlexNet, LeNet, get_model
from distributed_ml_pytorch_tpu_torch.models.transformer import TransformerLM

__all__ = ["AlexNet", "LeNet", "TransformerLM", "get_model"]
