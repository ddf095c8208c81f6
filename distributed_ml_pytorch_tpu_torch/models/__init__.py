from distributed_ml_pytorch_tpu_torch.models.cnn import AlexNet, LeNet, get_model
from distributed_ml_pytorch_tpu_torch.models.transformer import TransformerLM
from distributed_ml_pytorch_tpu_torch.models.moe import MoETransformerLM
from distributed_ml_pytorch_tpu_torch.models.resnet import ResNet, get_resnet
from distributed_ml_pytorch_tpu_torch.models.generate import generate

__all__ = ["AlexNet", "LeNet", "MoETransformerLM", "ResNet", "TransformerLM", "generate",
           "get_model", "get_resnet"]
