"""Role makers (mirrors
``paddle_tpu/incubate/fleet/base/role_maker.py``; the reference Fluid's
``role_maker.py``: MPI:146, PaddleCloud:337, UserDefined:399).

They read the same environment and user configuration as the
reference's; the cluster identity they give feeds
``torch.distributed.init_process_group`` (``Fleet.init``).
"""

import os

__all__ = [
    "Role",
    "RoleMakerBase",
    "UserDefinedRoleMaker",
    "UserDefinedCollectiveRoleMaker",
    "PaddleCloudRoleMaker",
]


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._worker_endpoints = []
        self._server_endpoints = []
        self._role_is_generated = False
        self._role = Role.WORKER
        self._current_id = 0

    def generate_role(self):
        self._role_is_generated = True

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return len(self._worker_endpoints) or 1

    def server_num(self):
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        return self._worker_endpoints

    def get_pserver_endpoints(self):
        return self._server_endpoints


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._worker_num = worker_num
        self._server_endpoints = server_endpoints or []

    def worker_num(self):
        return self._worker_num


class UserDefinedCollectiveRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, worker_endpoints=None):
        super().__init__()
        self._current_id = current_id
        self._worker_endpoints = worker_endpoints or ["127.0.0.1:6170"]
        self._role = Role.WORKER


class PaddleCloudRoleMaker(RoleMakerBase):
    """Parses the PADDLE_* env contract (reference role_maker.py:337):
    PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ENDPOINTS,
    PADDLE_PORT, TRAINING_ROLE, PADDLE_PSERVERS_IP_PORT_LIST."""

    def __init__(self, is_collective=True):
        super().__init__()
        self._is_collective = is_collective

    def generate_role(self):
        if self._role_is_generated:
            return
        self._role_is_generated = True
        role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        self._role = Role.WORKER if role == "TRAINER" else Role.SERVER
        self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = [e for e in eps.split(",") if e]
        ps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = [e for e in ps.split(",") if e]

    def worker_num(self):
        self.generate_role()
        return (
            len(self._worker_endpoints)
            or int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        )
