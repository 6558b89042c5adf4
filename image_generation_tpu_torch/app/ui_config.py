"""UI/product constants — the reference's ``demo_configs.py`` equivalents.

A copy of ``image_generation_tpu/app/ui_config.py``, used by the web app
(``app/server.py``), the model-diagram generator and the figure writers.
"""

THEME_COLOR = "#074C91"  # header/buttons; dark, accessible with white text
THEME_COLOR_SECONDARY = "#2A7DE1"  # sliders, tabs, loading accents

APP_TITLE = "ML Image Generation (TPU)"  # the system's name, as the JAX app's page
MAIN_HEADER = "ML Image Generation"
DESCRIPTION = (
    "Machine-learning MNIST training and image generation using a Discrete "
    "Variational Autoencoder (DVAE) and a Graph-Restricted Boltzmann Machine "
    "(GRBM) prior, sampled on-device with block-Gibbs / parallel tempering."
)

DEFAULT_QPU = "Advantage2_system1"

GENERATE_NEW_MODEL_DIAGRAM = True  # refresh the model-diagram images per epoch

EXAMPLE_IMAGE_INDEX = 0  # dataset index of the UI example image

GRAPH_COLORS = ["#FF7006", "#17BEBB"]  # −1 spins, +1 spins

SLIDER_LATENTS = {"min": 128, "max": 512, "step": 64, "value": 256}
SLIDER_EPOCHS = {"min": 1, "max": 60, "step": 1, "value": 10}

SHARPEN_OUTPUT = False
UPPER_THRESHOLD = 0.6
LOWER_THRESHOLD = 0.4
