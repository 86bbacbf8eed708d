"""The admin shell: the port of seaweedfs_tpu/shell/. The fs.* verbs
(the reference's fs_commands.py) are registered by commands.py and wait
for the filer (ROADMAP item 11)."""
from seaweedfs_tpu_torch.shell.command_env import CommandEnv
from seaweedfs_tpu_torch.shell.commands import COMMANDS, run_command

__all__ = ["CommandEnv", "COMMANDS", "run_command"]
