"""Models of the port: ``resnet`` (ResNet-4/8/18, paper Appendix A)."""
