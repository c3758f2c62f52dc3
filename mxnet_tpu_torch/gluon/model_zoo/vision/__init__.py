"""gluon.model_zoo.vision (parity: gluon/model_zoo/vision/__init__.py:75-85).

alexnet, densenet, inception-v3, resnet v1/v2, squeezenet, vgg, mobilenet.
"""
from .resnet import (get_resnet, resnet18_v1, resnet34_v1, resnet50_v1,
                     resnet101_v1, resnet152_v1, resnet18_v2, resnet34_v2,
                     resnet50_v2, resnet101_v2, resnet152_v2,
                     ResNetV1, ResNetV2, BasicBlockV1, BasicBlockV2,
                     BottleneckV1, BottleneckV2)
from .alexnet import alexnet, AlexNet
from .vgg import (vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn, vgg16_bn,
                  vgg19_bn, get_vgg, VGG)
from .squeezenet import squeezenet1_0, squeezenet1_1, SqueezeNet
from .densenet import (densenet121, densenet161, densenet169, densenet201,
                       DenseNet)
from .inception import inception_v3, Inception3
from .mobilenet import (mobilenet1_0, mobilenet0_75, mobilenet0_5,
                        mobilenet0_25, get_mobilenet, MobileNet)


def get_model(name, **kwargs):
    """Create a model by name (parity: model_zoo.vision.get_model)."""
    models = {
        "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
        "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
        "resnet152_v1": resnet152_v1,
        "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
        "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
        "resnet152_v2": resnet152_v2,
        "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
        "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
        "vgg19_bn": vgg19_bn,
        "alexnet": alexnet,
        "densenet121": densenet121, "densenet161": densenet161,
        "densenet169": densenet169, "densenet201": densenet201,
        "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
        "inceptionv3": inception_v3,
        "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
        "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    }
    name = name.lower()
    if name not in models:
        raise ValueError(
            f"Model {name} is not supported. Available options are\n\t" +
            "\n\t".join(sorted(models.keys())))
    return models[name](**kwargs)
