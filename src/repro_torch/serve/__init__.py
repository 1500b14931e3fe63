from repro_torch.serve.decode import (ServeConfig, ServingLoop, generate,
                                      sample_token)

__all__ = ["ServeConfig", "ServingLoop", "generate", "sample_token"]
