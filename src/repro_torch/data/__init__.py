from repro_torch.data.pipeline import AudioStub, SyntheticLM, VisionStub

__all__ = ["AudioStub", "SyntheticLM", "VisionStub"]
