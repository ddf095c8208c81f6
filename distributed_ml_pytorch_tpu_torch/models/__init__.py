from distributed_ml_pytorch_tpu_torch.models.cnn import AlexNet, LeNet, get_model
from distributed_ml_pytorch_tpu_torch.models.transformer import TransformerLM
from distributed_ml_pytorch_tpu_torch.models.generate import generate

__all__ = ["AlexNet", "LeNet", "TransformerLM", "generate", "get_model"]
