"""The admin shell: the port of seaweedfs_tpu/shell/, the fs.* verbs
(shell/fs_commands.py) included."""
from seaweedfs_tpu_torch.shell.command_env import CommandEnv
from seaweedfs_tpu_torch.shell.commands import COMMANDS, run_command
from seaweedfs_tpu_torch.shell import fs_commands  # noqa: F401  (registers fs.*)

__all__ = ["CommandEnv", "COMMANDS", "run_command"]
