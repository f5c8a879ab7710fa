from pnr_tpu_torch.ui.dialog import CommonDialog, prompt_parameters

__all__ = ["CommonDialog", "prompt_parameters"]
