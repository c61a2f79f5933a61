"""Stage-2 training: `SeenmaskTrainer.train_epoch` over and over on a
frozen seeded trunk (the seenmask head and its learned x32 upsample
trained by Adam; the trunk's no-gradient forward, dropout drawn). See
`benchmark.training`."""

from benchmark.training import TrainDriver


class Driver(TrainDriver):
    stage = 2

    def make_trainer(self):
        from zeroshotsemanticsegmentation_tpu_torch.train import (
            SeenmaskTrainer, make_seenmask_optimizer)
        opt = make_seenmask_optimizer(self.model, lr=float(self.mix["lr"]))
        return SeenmaskTrainer(cfg=self.pcfg, model=self.model,
                               optimizer=opt, train_loader=self.loader,
                               val_loader=self.loader, logger=self.logger)
