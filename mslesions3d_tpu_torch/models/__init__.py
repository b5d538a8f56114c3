"""SSD3D model: config, priors, layers, MobileNet backbone, heads."""
