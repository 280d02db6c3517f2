from .cnn import RESNET50, RESNET152, Bottleneck, ResNet, ResNetConfig
